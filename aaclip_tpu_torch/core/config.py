"""Model architecture configuration and dtype policy.

The production architecture is OpenAI CLIP ViT-L/14-336 evaluated at
img_size 518 with its 12-layer, 768-wide text tower; ``tiny-test`` is a
2-layer, 64-wide vision and 32-wide text model for the CPU tests.
The JSON files under ``model_configs/`` are this package's own copy of the
registry (the reference's schema: ``embed_dim`` + ``vision_cfg`` +
``text_cfg``).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import warnings
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 518          # run-time resolution
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 768
    heads: int = 12
    layers: int = 12
    mlp_ratio: float = 4.0

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Two-tower model config. Both towers project to ``embed_dim``.
    ``quick_gelu`` False means exact-erf GELU, the reference's default for
    the ViT-L model."""

    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    embed_dim: int = 768
    quick_gelu: bool = False

    def with_image_size(self, image_size: int) -> "CLIPConfig":
        if image_size % self.vision.patch_size:
            raise ValueError(
                f"img_size {image_size} is not a multiple of the "
                f"{self.vision.patch_size}px patch size")
        return dataclasses.replace(
            self,
            vision=dataclasses.replace(self.vision, image_size=image_size))


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    """Adapter hyper-parameters: the image side's blend weight, how many
    blocks get an adapter, the tapped depths, and whether the seg/det
    projections end in a LeakyReLU; the text side's blend weight and
    adapted block count."""

    image_adapt_weight: float = 0.1
    image_adapt_until: int = 6
    levels: Tuple[int, ...] = (6, 12, 18, 24)
    proj_relu: bool = False
    text_adapt_weight: float = 0.1
    text_adapt_until: int = 3


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Precision policy.

    Parameters are stored in fp32. ``compute_dtype`` is what matmul inputs
    are cast to (products always accumulate in fp32) and the residual
    stream's dtype. ``fast_act`` selects the tanh GELU. LayerNorm
    statistics and softmax always run in fp32.

    ``precision`` is the JAX package's dot precision for fp32 operands:
    "highest" true fp32 (TF32 off on the card), "high" the 3-pass product
    (bf16 hi and lo halves, hi·hi + hi·lo + lo·hi summed in fp32: XLA's
    F32_AS_3BF16; ``models/layers.py::matmul``), None for the bf16
    policy, whose operands are bf16 already. ``bf16_until=K`` stages the
    first K vision blocks of the INFERENCE path at single-pass bf16
    products (``prefix_policy``) while the residual stream and every later
    block keep this policy; the training steps drop it (``unstaged``).

    ``quant_int8`` (``int8()``, inference only) stores the trunk's big
    matmul weights (packed QKV, attention out-projection, both MLP weights)
    as per-output-channel int8 and runs those products int8 x int8 ->
    int32 with per-token activation quantization (``ops/quant.py``);
    ``int8_until=K`` quantizes only blocks [0, K) and keeps the rest at the
    compute dtype (0 = the whole trunk). The training steps refuse it.
    """

    compute_dtype: torch.dtype = torch.float32
    fast_act: bool = False
    precision: str | None = "highest"
    bf16_until: int = 0
    quant_int8: bool = False
    int8_until: int = 0

    def prefix_policy(self) -> "DtypePolicy":
        """The policy of the bf16-staged leading vision blocks: single-pass
        bf16 matmul inputs, the same activation, staging cleared."""
        return dataclasses.replace(self, compute_dtype=torch.bfloat16,
                                   precision=None, bf16_until=0)

    def unstaged(self) -> "DtypePolicy":
        """This policy with the trunk staging off (the training steps)."""
        if not self.bf16_until:
            return self
        return dataclasses.replace(self, bf16_until=0)

    @classmethod
    def fp32(cls) -> "DtypePolicy":
        """Parity path: true fp32 matmuls (no TF32), erf GELU."""
        return cls(torch.float32, False, "highest")

    @classmethod
    def bf16(cls) -> "DtypePolicy":
        """Fast path: bf16 matmul inputs with fp32 accumulation, tanh GELU,
        bf16 residual stream."""
        return cls(torch.bfloat16, True, None)

    @classmethod
    def fp32_high(cls) -> "DtypePolicy":
        """Fast-parity path: fp32 parameters, residual stream and erf GELU,
        every fp32 product 3-pass (the attention kernels' 3-pass mode
        included), and on the inference path the first 6 vision blocks
        (the adapter-blend range) staged at single-pass bf16 products;
        ``bf16_until=0`` gives the unstaged 3-pass trunk."""
        return cls(torch.float32, False, "high", bf16_until=6)

    @classmethod
    def int8(cls) -> "DtypePolicy":
        """Quantized inference path: the bf16 fast path with the trunk's big
        matmuls on int8 x int8 -> int32 products (``ops/quant.py``: weights
        per output channel, activations per token). Inference only."""
        return cls(torch.bfloat16, True, None, quant_int8=True)

    @classmethod
    def from_name(cls, name: str) -> "DtypePolicy":
        """CLI --precision string -> policy."""
        try:
            factory = {"fp32": cls.fp32, "fp32_high": cls.fp32_high,
                       "bf16": cls.bf16, "int8": cls.int8}[name]
        except KeyError:
            raise ValueError(f"unknown precision {name!r}") from None
        return factory()


PRECISION_CHOICES = ("fp32", "fp32_high", "bf16", "int8")

VIT_L_14_336 = CLIPConfig()

# 2-layer towers, 64-wide vision at 70 px (5x5 grid), 32-wide text.
TINY_TEST = CLIPConfig(
    vision=VisionConfig(image_size=70, patch_size=14, width=64, layers=2,
                        heads=4),
    text=TextConfig(width=32, heads=4, layers=2),
    embed_dim=32,
)

MODEL_CONFIGS = {
    "ViT-L-14-336": VIT_L_14_336,
    "tiny-test": TINY_TEST,
}


def config_from_json(payload: dict) -> CLIPConfig:
    """CLIPConfig from the reference's JSON schema."""
    v, t = payload["vision_cfg"], payload["text_cfg"]
    return CLIPConfig(
        vision=VisionConfig(
            image_size=v["image_size"], patch_size=v["patch_size"],
            width=v["width"], layers=v["layers"],
            heads=v["width"] // v.get("head_width", 64),
            mlp_ratio=v.get("mlp_ratio", 4.0)),
        text=TextConfig(
            context_length=t["context_length"], vocab_size=t["vocab_size"],
            width=t["width"], heads=t["heads"], layers=t["layers"],
            mlp_ratio=t.get("mlp_ratio", 4.0)),
        embed_dim=payload["embed_dim"],
        quick_gelu=payload.get("quick_gelu", False),
    )


def _scan_json_configs() -> None:
    """Add model_configs/*.json to MODEL_CONFIGS, then the JSON files of
    the directories named in ``AACLIP_MODEL_CONFIGS`` (``os.pathsep``
    separated), as the JAX package scans them. The built-in entries above
    win over a built-in file of the same name; a user file overrides
    either. A file without ``embed_dim``, ``vision_cfg`` and ``text_cfg``
    is skipped; an unreadable user file warns and is skipped, an
    unreadable built-in one raises naming the file."""
    dirs = [(os.path.join(os.path.dirname(__file__), "model_configs"),
             False)]
    extra = os.environ.get("AACLIP_MODEL_CONFIGS")
    if extra:
        dirs += [(d, True) for d in extra.split(os.pathsep)]
    for d, user in dirs:
        for path in sorted(glob.glob(os.path.join(d, "*.json"))):
            name = os.path.splitext(os.path.basename(path))[0]
            if name in MODEL_CONFIGS and not user:
                continue
            try:
                with open(path) as f:
                    payload = json.load(f)
                if not all(k in payload
                           for k in ("embed_dim", "vision_cfg", "text_cfg")):
                    continue
                parsed = config_from_json(payload)
            except (OSError, ValueError, KeyError, TypeError,
                    AttributeError, ZeroDivisionError) as e:
                # what a missing, malformed or mistyped file raises
                if user:
                    warnings.warn(
                        f"skipping unreadable model config {path!r}: {e}")
                    continue
                raise RuntimeError(
                    f"could not load model config {path!r}: {e}") from e
            MODEL_CONFIGS[name] = parsed


_scan_json_configs()


def get_config(model_name: str, img_size: int | None = None) -> CLIPConfig:
    """Look up a named architecture, optionally overriding the run-time
    image size."""
    name = model_name.replace("/", "-")
    if name not in MODEL_CONFIGS:
        raise KeyError(f"Model config for {name} not found; available: "
                       f"{sorted(MODEL_CONFIGS)}")
    cfg = MODEL_CONFIGS[name]
    if img_size is not None and img_size != cfg.vision.image_size:
        cfg = cfg.with_image_size(img_size)
    return cfg

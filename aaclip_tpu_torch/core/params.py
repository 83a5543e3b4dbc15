"""Parameters of the vision tower and the image adapters: random init on
the device from a ``torch.Generator``, loading from the JAX package's
parameter tree, and the compute-dtype cast.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from aaclip_tpu_torch.core.config import (AdapterConfig, CLIPConfig,
                                          DtypePolicy)
from aaclip_tpu_torch.device import resolve_device
from aaclip_tpu_torch.models.vit import ImageAdapter, VisionTransformer


def init_vision_params(cfg: CLIPConfig, *, seed: int = 0,
                       device=None) -> VisionTransformer:
    """Random frozen fp32 image tower generated on ``device`` (CLIP's init
    scales: attention width^-0.5, projections half that, fc (2w)^-0.5;
    zero biases, unit LayerNorms)."""
    dev = resolve_device(device)
    v = cfg.vision
    with torch.device("meta"):
        vit = VisionTransformer(v)
    vit = vit.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    attn_std = v.width ** -0.5
    proj_std = attn_std * 0.5
    fc_std = (2 * v.width) ** -0.5
    patch_dim = 3 * v.patch_size * v.patch_size

    def normal(t, std):
        with torch.no_grad():
            t.normal_(0.0, std, generator=gen)

    vit.requires_grad_(False)  # the CLIP tower is frozen; adapters train
    for mod in vit.modules():
        if isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    normal(vit.conv1.weight, patch_dim ** -0.5)
    normal(vit.class_embedding, attn_std)
    normal(vit.positional_embedding, attn_std)
    for blk in vit.blocks:
        normal(blk.attn.in_proj_weight, attn_std)
        normal(blk.attn.out_proj.weight, proj_std)
        normal(blk.mlp.c_fc.weight, fc_std)
        normal(blk.mlp.c_proj.weight, proj_std)
        for b in (blk.attn.in_proj_bias, blk.attn.out_proj.bias,
                  blk.mlp.c_fc.bias, blk.mlp.c_proj.bias):
            nn.init.zeros_(b)
    return vit


def init_image_adapter(cfg: CLIPConfig, acfg: AdapterConfig, *,
                       seed: int = 1, device=None) -> ImageAdapter:
    """Image adapters with Xavier-uniform weights, fp32, on ``device``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        adapter = ImageAdapter(cfg, acfg)
    adapter = adapter.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for p in adapter.parameters():
        nn.init.xavier_uniform_(p, generator=gen)
    return adapter


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _load(param: torch.Tensor, value) -> None:
    value = _f32(value)
    if value.shape != param.shape:
        raise ValueError(f"shape mismatch: {tuple(value.shape)} into "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def params_from_jax(tree: dict, cfg: CLIPConfig, *,
                    device=None) -> VisionTransformer:
    """Frozen image tower from the JAX package's parameter tree (numpy or
    array leaves; the full CLIP tree or its ``"visual"`` subtree). JAX
    linear weights are ``[in, out]`` and the blocks are stacked on a
    leading layer axis; both are undone here."""
    dev = resolve_device(device)
    t = tree.get("visual", tree)
    with torch.device("meta"):
        vit = VisionTransformer(cfg.vision)
    vit = vit.to_empty(device=dev).requires_grad_(False)
    _load(vit.conv1.weight, np.asarray(t["conv1"]["w"], np.float32).T)
    _load(vit.class_embedding, t["class_embedding"])
    _load(vit.positional_embedding, t["positional_embedding"])
    for name in ("ln_pre", "ln_post"):
        _load(getattr(vit, name).weight, t[name]["scale"])
        _load(getattr(vit, name).bias, t[name]["bias"])
    blocks = {k: {kk: np.asarray(vv, np.float32) for kk, vv in v.items()}
              for k, v in t["blocks"].items()}
    for i, blk in enumerate(vit.blocks):
        for name in ("ln_1", "ln_2"):
            _load(getattr(blk, name).weight, blocks[name]["scale"][i])
            _load(getattr(blk, name).bias, blocks[name]["bias"][i])
        a, m = blocks["attn"], blocks["mlp"]
        _load(blk.attn.in_proj_weight, a["w_qkv"][i].T)
        _load(blk.attn.in_proj_bias, a["b_qkv"][i])
        _load(blk.attn.out_proj.weight, a["w_out"][i].T)
        _load(blk.attn.out_proj.bias, a["b_out"][i])
        _load(blk.mlp.c_fc.weight, m["w_fc"][i].T)
        _load(blk.mlp.c_fc.bias, m["b_fc"][i])
        _load(blk.mlp.c_proj.weight, m["w_proj"][i].T)
        _load(blk.mlp.c_proj.bias, m["b_proj"][i])
    return vit


def adapter_from_jax(tree: dict, cfg: CLIPConfig, acfg: AdapterConfig, *,
                     device=None) -> ImageAdapter:
    """Image adapters from the JAX package's ``adapters["image"]`` tree."""
    dev = resolve_device(device)
    with torch.device("meta"):
        adapter = ImageAdapter(cfg, acfg)
    adapter = adapter.to_empty(device=dev)
    stacked = np.asarray(tree["layer_adapters"]["w"], np.float32)
    if len(stacked) != len(adapter.layer_adapters):
        raise ValueError(f"{len(stacked)} layer adapters in the tree, "
                         f"image_adapt_until={acfg.image_adapt_until}")
    for lin, w in zip(adapter.layer_adapters, stacked):
        _load(lin.weight, w.T)
    if len(tree["seg_proj"]) != len(adapter.seg_proj):
        raise ValueError(f"{len(tree['seg_proj'])} seg projections in the "
                         f"tree, {len(acfg.levels)} levels configured")
    for lin, p in zip(adapter.seg_proj, tree["seg_proj"]):
        _load(lin.weight, np.asarray(p["w"], np.float32).T)
    _load(adapter.det_proj.weight,
          np.asarray(tree["det_proj"]["w"], np.float32).T)
    return adapter


def adapter_to_jax(adapter: ImageAdapter) -> dict:
    """The inverse of ``adapter_from_jax``: the JAX package's
    ``adapters["image"]`` tree of fp32 numpy arrays (``[in, out]`` linear
    weights, the layer adapters stacked on a leading axis)."""
    def w(lin):
        return lin.weight.detach().float().cpu().numpy().T.copy()

    return {
        "layer_adapters": {"w": np.stack([w(l)
                                          for l in adapter.layer_adapters])},
        "seg_proj": [{"w": w(l)} for l in adapter.seg_proj],
        "det_proj": {"w": w(adapter.det_proj)},
    }


def cast_matmul_weights(vit: VisionTransformer,
                        policy: DtypePolicy) -> VisionTransformer:
    """A copy of ``vit`` with its weights pre-cast to the compute dtype
    (``vit`` itself when that is the storage dtype).

    The cast follows the JAX package, whose stacked block leaves are all
    at least 2-D: every block parameter is cast, LayerNorm affines and
    biases included, while outside the blocks only >= 2-D weights are
    (ln_pre/ln_post and the class embedding stay fp32)."""
    cd = policy.compute_dtype
    if cd == torch.float32:
        return vit
    out = copy.deepcopy(vit)
    with torch.no_grad():
        for p in out.blocks.parameters():
            p.data = p.data.to(cd)
        for name, p in out.named_parameters():
            if not name.startswith("blocks.") and p.dim() >= 2:
                p.data = p.data.to(cd)
    return out

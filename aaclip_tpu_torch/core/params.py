"""Parameters of both towers and of the adapters: random init on the
device from a ``torch.Generator``, loading from (and, for the adapters,
back to) the JAX package's parameter tree, and the compute-dtype casts.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from aaclip_tpu_torch.core.config import (AdapterConfig, CLIPConfig,
                                          DtypePolicy)
from aaclip_tpu_torch.device import resolve_device
from aaclip_tpu_torch.models.text_model import TextAdapter, TextTransformer
from aaclip_tpu_torch.models.vit import ImageAdapter, VisionTransformer


def _init_tower(tower: nn.Module, width: int, gen: torch.Generator) -> None:
    """CLIP's init of a tower's blocks (attention width^-0.5, projections
    half that, fc (2w)^-0.5; zero biases) and unit LayerNorms; freezes the
    tower."""
    attn_std = width ** -0.5
    proj_std = attn_std * 0.5
    fc_std = (2 * width) ** -0.5
    tower.requires_grad_(False)  # the CLIP towers are frozen
    for mod in tower.modules():
        if isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    for blk in tower.blocks:
        _normal(blk.attn.in_proj_weight, attn_std, gen)
        _normal(blk.attn.out_proj.weight, proj_std, gen)
        _normal(blk.mlp.c_fc.weight, fc_std, gen)
        _normal(blk.mlp.c_proj.weight, proj_std, gen)
        for b in (blk.attn.in_proj_bias, blk.attn.out_proj.bias,
                  blk.mlp.c_fc.bias, blk.mlp.c_proj.bias):
            nn.init.zeros_(b)


def _normal(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=gen)


def init_vision_params(cfg: CLIPConfig, *, seed: int = 0,
                       device=None) -> VisionTransformer:
    """Random frozen fp32 image tower generated on ``device`` (CLIP's init
    scales; zero biases, unit LayerNorms). ``proj`` is drawn last, so the
    rest of the tower is what the same seed gave before it existed."""
    dev = resolve_device(device)
    v = cfg.vision
    with torch.device("meta"):
        vit = VisionTransformer(v, cfg.embed_dim)
    vit = vit.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    attn_std = v.width ** -0.5
    patch_dim = 3 * v.patch_size * v.patch_size
    _normal(vit.conv1.weight, patch_dim ** -0.5, gen)
    _normal(vit.class_embedding, attn_std, gen)
    _normal(vit.positional_embedding, attn_std, gen)
    _init_tower(vit, v.width, gen)
    _normal(vit.proj, attn_std, gen)
    return vit


def init_text_params(cfg: CLIPConfig, *, seed: int = 0,
                     device=None) -> TextTransformer:
    """Random frozen fp32 text tower generated on ``device``, with the JAX
    package's init scales (token embedding 0.02, positions 0.01, blocks as
    the image tower's, projection width^-0.5)."""
    dev = resolve_device(device)
    t = cfg.text
    with torch.device("meta"):
        text = TextTransformer(cfg)
    text = text.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    _normal(text.token_embedding.weight, 0.02, gen)
    _normal(text.positional_embedding, 0.01, gen)
    _init_tower(text, t.width, gen)
    _normal(text.text_projection, t.width ** -0.5, gen)
    return text


def _xavier_module(module: nn.Module, seed: int, device) -> nn.Module:
    dev = resolve_device(device)
    module = module.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for p in module.parameters():
        nn.init.xavier_uniform_(p, generator=gen)
    return module


def init_image_adapter(cfg: CLIPConfig, acfg: AdapterConfig, *,
                       seed: int = 1, device=None) -> ImageAdapter:
    """Image adapters with Xavier-uniform weights, fp32, on ``device``."""
    with torch.device("meta"):
        adapter = ImageAdapter(cfg, acfg)
    return _xavier_module(adapter, seed, device)


def init_text_adapter(cfg: CLIPConfig, acfg: AdapterConfig, *,
                      seed: int = 2, device=None) -> TextAdapter:
    """Text adapters with Xavier-uniform weights (reference
    model/adapter.py:47-53), fp32, on ``device``."""
    with torch.device("meta"):
        adapter = TextAdapter(cfg, acfg)
    return _xavier_module(adapter, seed, device)


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _load(param: torch.Tensor, value) -> None:
    value = _f32(value)
    if value.shape != param.shape:
        raise ValueError(f"shape mismatch: {tuple(value.shape)} into "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def _load_blocks(blocks: nn.ModuleList, stacked: dict) -> None:
    """Residual blocks from the JAX package's stacked block tree (leading
    layer axis, ``[in, out]`` linear weights)."""
    t = {k: {kk: np.asarray(vv, np.float32) for kk, vv in v.items()}
         for k, v in stacked.items()}
    for i, blk in enumerate(blocks):
        for name in ("ln_1", "ln_2"):
            _load(getattr(blk, name).weight, t[name]["scale"][i])
            _load(getattr(blk, name).bias, t[name]["bias"][i])
        a, m = t["attn"], t["mlp"]
        _load(blk.attn.in_proj_weight, a["w_qkv"][i].T)
        _load(blk.attn.in_proj_bias, a["b_qkv"][i])
        _load(blk.attn.out_proj.weight, a["w_out"][i].T)
        _load(blk.attn.out_proj.bias, a["b_out"][i])
        _load(blk.mlp.c_fc.weight, m["w_fc"][i].T)
        _load(blk.mlp.c_fc.bias, m["b_fc"][i])
        _load(blk.mlp.c_proj.weight, m["w_proj"][i].T)
        _load(blk.mlp.c_proj.bias, m["b_proj"][i])


def _load_ln(ln: nn.LayerNorm, tree: dict) -> None:
    _load(ln.weight, tree["scale"])
    _load(ln.bias, tree["bias"])


def params_from_jax(tree: dict, cfg: CLIPConfig, *,
                    device=None) -> VisionTransformer:
    """Frozen image tower from the JAX package's parameter tree (numpy or
    array leaves; the full CLIP tree or its ``"visual"`` subtree). JAX
    linear weights are ``[in, out]`` and the blocks are stacked on a
    leading layer axis; both are undone here. ``proj`` keeps its
    ``[width, embed_dim]`` layout."""
    dev = resolve_device(device)
    t = tree.get("visual", tree)
    with torch.device("meta"):
        vit = VisionTransformer(cfg.vision, cfg.embed_dim)
    vit = vit.to_empty(device=dev).requires_grad_(False)
    _load(vit.conv1.weight, np.asarray(t["conv1"]["w"], np.float32).T)
    _load(vit.class_embedding, t["class_embedding"])
    _load(vit.positional_embedding, t["positional_embedding"])
    _load_ln(vit.ln_pre, t["ln_pre"])
    _load_ln(vit.ln_post, t["ln_post"])
    _load(vit.proj, t["proj"])
    _load_blocks(vit.blocks, t["blocks"])
    return vit


def text_params_from_jax(tree: dict, cfg: CLIPConfig, *,
                         device=None) -> TextTransformer:
    """Frozen text tower from the JAX package's tree (the full CLIP tree or
    its ``"text"`` subtree): ``token_embedding``, ``positional_embedding``,
    the stacked blocks, ``ln_final`` and ``text_projection``."""
    dev = resolve_device(device)
    t = tree.get("text", tree)
    with torch.device("meta"):
        text = TextTransformer(cfg)
    text = text.to_empty(device=dev).requires_grad_(False)
    _load(text.token_embedding.weight, t["token_embedding"])
    _load(text.positional_embedding, t["positional_embedding"])
    _load_ln(text.ln_final, t["ln_final"])
    _load(text.text_projection, t["text_projection"])
    _load_blocks(text.blocks, t["blocks"])
    return text


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
    return {
        "layer_adapters": {"w": np.stack([_w_in_out(l)
                                          for l in adapter.layer_adapters])},
        "seg_proj": [{"w": _w_in_out(l)} for l in adapter.seg_proj],
        "det_proj": {"w": _w_in_out(adapter.det_proj)},
    }


def text_adapter_from_jax(tree: dict, cfg: CLIPConfig, acfg: AdapterConfig,
                          *, device=None) -> TextAdapter:
    """Text adapters from the JAX package's ``adapters["text"]`` tree
    (``layer_adapters`` ``[n, tw, tw]`` stacked, ``proj`` ``[tw, tw]``,
    both ``[in, out]``)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        adapter = TextAdapter(cfg, acfg)
    adapter = adapter.to_empty(device=dev)
    stacked = np.asarray(tree["layer_adapters"]["w"], np.float32)
    if len(stacked) != len(adapter.layer_adapters):
        raise ValueError(f"{len(stacked)} text layer adapters in the tree, "
                         f"text_adapt_until={acfg.text_adapt_until}")
    for lin, w in zip(adapter.layer_adapters, stacked):
        _load(lin.weight, w.T)
    _load(adapter.proj.weight, np.asarray(tree["proj"]["w"], np.float32).T)
    return adapter


def _w_in_out(lin: nn.Linear) -> np.ndarray:
    return lin.weight.detach().float().cpu().numpy().T.copy()


def text_adapter_to_jax(adapter: TextAdapter) -> dict:
    """The inverse of ``text_adapter_from_jax``: the JAX package's
    ``adapters["text"]`` tree of fp32 numpy arrays."""
    return {
        "layer_adapters": {"w": np.stack([_w_in_out(l)
                                          for l in adapter.layer_adapters])},
        "proj": {"w": _w_in_out(adapter.proj)},
    }


def cast_matmul_weights(vit: VisionTransformer,
                        policy: DtypePolicy) -> VisionTransformer:
    """A copy of ``vit`` with its weights pre-cast to the compute dtype
    (``vit`` itself when that is the storage dtype), for the predictor.

    The cast follows the JAX predictor (``eval/predict.py:68``), whose
    stacked block leaves are all at least 2-D: every block parameter is
    cast, LayerNorm affines and biases included, while outside the blocks
    only >= 2-D weights are (ln_pre/ln_post and the class embedding stay
    fp32)."""
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


def cast_block_matrices(tower: nn.Module, policy: DtypePolicy) -> nn.Module:
    """A copy of ``tower`` (image or text) whose blocks' 2-D matmul weights
    are pre-cast to the compute dtype (``tower`` itself when that is the
    storage dtype), for the training steps.

    The JAX training steps keep the fp32 parameters as stored and cast
    each weight at its product (``layers.linear``), which a pre-cast 2-D
    weight reproduces; biases are added in fp32 and LayerNorm affines
    applied in fp32, so they stay fp32 here, as does everything outside
    the blocks (each use casts it as JAX does)."""
    cd = policy.compute_dtype
    if cd == torch.float32:
        return tower
    out = copy.deepcopy(tower)
    with torch.no_grad():
        for p in out.blocks.parameters():
            if p.dim() == 2:
                p.data = p.data.to(cd)
    return out

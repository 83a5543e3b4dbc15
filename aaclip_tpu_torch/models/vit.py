"""Vision transformer tower (ViT-L/14), the adapted image forward and
the frozen image encoder.

``VisionTransformer`` holds the frozen CLIP weights (an ``nn.ModuleList``
of ``ResidualBlock``s); ``ImageAdapter`` holds the trainable adapters:
one bias-free linear per adapted block, one seg projection per tapped
level and the det projection. ``adapted_forward`` runs the trunk with
norm-matched adapter blends after the first ``image_adapt_until`` blocks
and taps the residual stream at the requested depths, then ln_post, the
seg/det projections and L2 normalisation on their fp32 output.
``encode_image`` runs the frozen tower (V-V blocks from ``vv_start``)
to the projected CLS embedding. Each takes the whole-block override
``block_fn`` of ``models/layers.residual_block``.

The patch embedding is a reshape and one matmul (ops/preprocess.py).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from aaclip_tpu_torch.core.config import (AdapterConfig, CLIPConfig,
                                          DtypePolicy, VisionConfig)
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.ops.preprocess import patchify


class VisionTransformer(nn.Module):
    """CLIP image tower weights. ``conv1`` is the patch embedding as a
    linear layer over (c, ky, kx)-flattened patches; ``proj`` is the CLS
    projection [width, embed_dim], used as ``x @ proj`` (the stage-1
    features project through it)."""

    def __init__(self, v: VisionConfig, embed_dim: int):
        super().__init__()
        patch_dim = 3 * v.patch_size * v.patch_size
        self.conv1 = nn.Linear(patch_dim, v.width, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(v.width))
        self.positional_embedding = nn.Parameter(
            torch.empty(v.seq_len, v.width))
        self.ln_pre = nn.LayerNorm(v.width, eps=L._LN_EPS)
        self.blocks = nn.ModuleList(
            L.ResidualBlock(v.width, v.mlp_ratio)
            for _ in range(v.layers))
        self.ln_post = nn.LayerNorm(v.width, eps=L._LN_EPS)
        self.proj = nn.Parameter(torch.empty(v.width, embed_dim))


class ImageAdapter(nn.Module):
    """Trainable image-side adapters (all linears bias-free)."""

    def __init__(self, cfg: CLIPConfig, acfg: AdapterConfig):
        super().__init__()
        vw, ed = cfg.vision.width, cfg.embed_dim
        self.layer_adapters = nn.ModuleList(
            nn.Linear(vw, vw, bias=False)
            for _ in range(acfg.image_adapt_until))
        self.seg_proj = nn.ModuleList(
            nn.Linear(vw, ed, bias=False) for _ in acfg.levels)
        self.det_proj = nn.Linear(vw, ed, bias=False)


def embed(vit: VisionTransformer, cfg: CLIPConfig, images: torch.Tensor,
          policy: DtypePolicy = DtypePolicy(),
          patch_embed_fn=None) -> torch.Tensor:
    """Patchify, prepend CLS, add positional embeddings, ln_pre. The
    residual stream is carried in the policy's compute dtype."""
    if patch_embed_fn is not None:
        x = patch_embed_fn(images)
    else:
        x = patchify(images, vit.conv1.weight.t(), cfg.vision.patch_size,
                     policy.compute_dtype, policy.precision)
    x = x.to(policy.compute_dtype)
    cls = vit.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1)
    x = x + vit.positional_embedding.to(x.dtype)
    return L.layer_norm(x, vit.ln_pre.weight, vit.ln_pre.bias)


def run_blocks(x: torch.Tensor, vit: VisionTransformer, cfg: CLIPConfig,
               start: int, stop: int, *, vv: bool = False, act,
               policy: DtypePolicy, attn_fn=None, vv_attn_fn=None,
               block_fn=None, vv_block_fn=None) -> torch.Tensor:
    """Blocks ``[start, stop)`` of the tower on the residual stream ``x``,
    in the V-V form when ``vv`` (the JAX package's ``run_block_range`` over
    ``slice_blocks``). Hooks left at None are the packed-attention kernel
    hooks of ``L.residual_block``; a block override replaces the block."""
    for i in range(start, stop):
        x = L.residual_block(x, vit.blocks[i], cfg.vision.heads, vv=vv,
                             act=act, policy=policy, attn_fn=attn_fn,
                             vv_attn_fn=vv_attn_fn, block_fn=block_fn,
                             vv_block_fn=vv_block_fn)
    return x


def quantize_prefix(visual: VisionTransformer, source: VisionTransformer,
                    until: int) -> VisionTransformer:
    """The mixed int8 prefix (``--int8_until``): blocks [0, ``until``) of
    ``visual`` quantized in place from ``source``'s blocks
    (``ops/quant.py::quantize_block_weights``), the rest left as they are.
    One ``ModuleList`` holds both kinds, and each product dispatches on its
    weight's dtype (``layers.linear``), so the trunk needs no second stack
    (JAX's scan does, since its stacked leaves share one dtype)."""
    from aaclip_tpu_torch.ops.quant import quantize_block_weights

    for i in range(until):
        quantize_block_weights(visual.blocks[i], source=source.blocks[i])
    return visual


def staged_depth(policy: DtypePolicy, layers: int) -> int:
    """How many leading blocks run under ``policy.prefix_policy()``: the
    policy's ``bf16_until``, at most the depth, and only when its compute
    dtype is 4 bytes (the JAX package's ``_trunk_with_taps``)."""
    if policy.bf16_until and policy.compute_dtype.itemsize >= 4:
        return min(policy.bf16_until, layers)
    return 0


def trunk_taps(vit: VisionTransformer, cfg: CLIPConfig, images: torch.Tensor,
               out_layers: Sequence[int], *, adapters: ImageAdapter | None,
               adapt_weight: float, act, policy: DtypePolicy, attn_fn=None,
               block_fn=None, patch_embed_fn=None,
               remat: bool | str = False) -> List[torch.Tensor]:
    """Residual stream after each 1-indexed depth in ``out_layers``. Block
    i (0-indexed) is followed by a norm-matched blend with adapter i while
    adapters remain; blocks past the deepest tap are not run. ``attn_fn``
    None means the packed-attention kernel hook (``L.residual_block``);
    ``block_fn`` replaces each whole block (inference only).

    ``policy.bf16_until`` stages the first ``staged_depth`` blocks, their
    adapters included, at ``policy.prefix_policy()`` (single-pass bf16
    products) with that policy's kernel hook (the bf16 kernel), whatever
    ``attn_fn`` is, as JAX's predictor builds its prefix hook; the
    residual stream, LayerNorm statistics, the blends and every later block
    keep ``policy``.

    ``remat=True`` runs each block (with its adapter blend) under
    ``torch.utils.checkpoint``, as the JAX package wraps each block in
    ``jax.checkpoint``: the backward recomputes the block instead of
    keeping its activations, the attention forward included.
    ``remat="selective"`` (the JAX package's ``save_only_these_names(
    "attn_out", "attn_qkv", "mlp_fc")``) runs each block as
    ``L.residual_block_selective``: the backward keeps the block's input,
    qkv, ``x + attn_out`` and ``mlp_fc`` and recomputes only LayerNorms,
    activations, adds and the adapter blend; ``attn_fn`` None then means
    the differentiable attention kernels. A block whose input carries no
    gradient (the first; the trunk is frozen) is run plainly under either:
    it has nothing to recompute for the backward, and its output is kept
    anyway as the next block's saved input.

    A tensor-parallel tower (``parallel/tensor.py::shard_tower``) runs its
    blocks on the rank's heads; under sequence parallelism the stream is
    split over the model axis after the embedding and each tap gathered
    (``L.stream_split``, ``L.stream_gather``)."""
    if remat not in (False, True, "selective"):
        raise ValueError(f"remat must be False, True or 'selective', got "
                         f"{remat!r}")
    if remat == "selective" and block_fn is not None:
        raise ValueError("block_fn overrides are inference-only; selective "
                         "remat runs the standard block")
    v = cfg.vision
    n_adapt = len(adapters.layer_adapters) if adapters is not None else 0
    if n_adapt > v.layers:
        raise ValueError(
            f"{n_adapt} adapters exceed the {v.layers}-layer tower; set "
            f"image_adapt_until to match the model config")
    bad = [l for l in out_layers if not 0 < l <= v.layers]
    if bad:
        raise ValueError(
            f"tap depths {bad} out of range for a {v.layers}-layer tower")
    x = L.stream_split(vit, embed(vit, cfg, images, policy, patch_embed_fn))
    stage_k = staged_depth(policy, v.layers)
    prefix = policy.prefix_policy() if stage_k else policy

    def blend(x, i, pol):
        a = L.simple_adapter(x, adapters.layer_adapters[i].weight, pol)
        return L.norm_matched_blend(x, a, adapt_weight)

    def block(x, i):
        pol, hook = (prefix, None) if i < stage_k else (policy, attn_fn)
        x = L.residual_block(x, vit.blocks[i], v.heads, act=act, policy=pol,
                             attn_fn=hook, block_fn=block_fn)
        return blend(x, i, pol) if i < n_adapt else x

    def selective_block(x, i):
        pol, hook = (prefix, None) if i < stage_k else (policy, attn_fn)
        tail = functools.partial(blend, i=i, pol=pol) if i < n_adapt \
            else None
        return L.residual_block_selective(x, vit.blocks[i], v.heads,
                                          act=act, policy=pol, attn_fn=hook,
                                          tail=tail)

    taps = {}
    for i in range(max(out_layers, default=0)):
        if remat == "selective" and x.requires_grad:
            x = selective_block(x, i)
        elif remat and x.requires_grad:
            x = checkpoint(block, x, i, use_reentrant=False)
        else:
            x = block(x, i)
        taps[i + 1] = x
    return [L.stream_gather(vit, taps[l]) for l in out_layers]


def adapted_forward(vit: VisionTransformer, adapter: ImageAdapter,
                    cfg: CLIPConfig, images: torch.Tensor, *,
                    image_adapt_weight: float = 0.1,
                    levels: Sequence[int] = (6, 12, 18, 24),
                    proj_relu: bool = False,
                    policy: DtypePolicy = DtypePolicy(), act=None,
                    attn_fn=None, block_fn=None, patch_embed_fn=None,
                    remat: bool | str = False
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """AdaptedCLIP image forward: ``(seg_tokens, det_token)``, a list of
    L2-normalised per-level patch embeddings [B, num_patches, embed_dim]
    (fp32) and the pooled detection embedding [B, embed_dim] (fp32).
    ``block_fn``, ``remat`` and the staged blocks as in ``trunk_taps``."""
    if act is None:
        act = L.config_act(cfg, policy)
    taps = trunk_taps(vit, cfg, images, levels, adapters=adapter,
                      adapt_weight=image_adapt_weight, act=act, policy=policy,
                      attn_fn=attn_fn, block_fn=block_fn,
                      patch_embed_fn=patch_embed_fn, remat=remat)
    tokens = [L.layer_norm(t[:, 1:, :], vit.ln_post.weight, vit.ln_post.bias)
              for t in taps]

    def proj_norm(t, lin):
        # bf16 matmul, L2-normalised on the fp32 output so the unit vectors
        # feeding the 100x similarity scores stay precise
        y = L.linear(t, lin.weight, None, policy)
        if proj_relu:
            y = L.leaky_relu(y)
        return L.l2_normalize(y)

    seg = [proj_norm(t, adapter.seg_proj[i]) for i, t in enumerate(tokens)]
    det = proj_norm(tokens[-1], adapter.det_proj).mean(dim=1)
    return seg, det


def encode_image(vit: VisionTransformer, cfg: CLIPConfig,
                 images: torch.Tensor, out_layers: Sequence[int] = (), *,
                 vv_start: int | None = None,
                 policy: DtypePolicy = DtypePolicy(), act=None, attn_fn=None,
                 vv_attn_fn=None, block_fn=None, vv_block_fn=None
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Frozen CLIP image forward: ``(pooled, taps)``, the CLS token of the
    last block through ``ln_post`` and ``proj`` [B, embed_dim] (in the
    stream's dtype), and the residual stream [B, 1 + num_patches, width]
    after each 1-indexed depth in ``out_layers``. Blocks with index >=
    ``vv_start`` (0-indexed) run in the V-V form. Hooks and block overrides
    as in ``L.residual_block``; ``policy.bf16_until`` stages the leading
    standard blocks as in ``trunk_taps`` (a V-V block is never staged)."""
    if act is None:
        act = L.config_act(cfg, policy)
    v = cfg.vision
    bad = [l for l in out_layers if not 0 < l <= v.layers]
    if bad:
        raise ValueError(
            f"tap depths {bad} out of range for a {v.layers}-layer tower")
    x = L.stream_split(vit, embed(vit, cfg, images, policy))
    stage_k = staged_depth(policy, v.layers)
    taps = {}
    for i in range(v.layers):
        vv = vv_start is not None and i >= vv_start
        staged = i < stage_k and not vv
        x = run_blocks(x, vit, cfg, i, i + 1, vv=vv, act=act,
                       policy=policy.prefix_policy() if staged else policy,
                       attn_fn=None if staged else attn_fn,
                       vv_attn_fn=vv_attn_fn, block_fn=block_fn,
                       vv_block_fn=vv_block_fn)
        if i + 1 in out_layers:
            taps[i + 1] = L.stream_gather(vit, x)
    x = L.stream_gather(vit, x)
    pooled = L.layer_norm(x[:, 0, :], vit.ln_post.weight, vit.ln_post.bias)
    cd = policy.compute_dtype
    pooled = L.matmul(pooled.to(cd), vit.proj.to(cd),
                      policy.precision).to(x.dtype)
    return pooled, [taps[l] for l in out_layers]


def surgery_patch_features(vit: VisionTransformer, cfg: CLIPConfig,
                           images: torch.Tensor, out_layers: Sequence[int],
                           surgery_until_layer: int = 20, *,
                           policy: DtypePolicy = DtypePolicy(), act=None,
                           attn_fn=None, vv_attn_fn=None, block_fn=None,
                           vv_block_fn=None, vv_mode: str = "batch"
                           ) -> List[torch.Tensor]:
    """Stage-1 features of the surgery tower (reference train.py:75-81):
    each tapped depth's patch tokens (CLS dropped) through ln_post and
    ``proj``, fp32 [B, num_patches, embed_dim]. The last
    ``surgery_until_layer - 1`` blocks run in the V-V form
    (``layers.surgery_vv_start``), as in ``train/steps.py::
    stage1_features_fn``: ``vv_mode="batch"`` (default) is the
    reference's batch-coupled V-V attention (``layers.
    make_batch_vv_attn_fn``, plain), ``"spatial"`` the per-sample form on
    ``vv_attn_fn`` (default the packed kernel's V-V mode). The policy's
    staging is dropped, as every stage-1 entry point drops it."""
    policy = policy.unstaged()
    if vv_mode == "batch":
        vv_attn_fn = L.make_batch_vv_attn_fn(cfg.vision.heads, policy)
        vv_block_fn = None
    elif vv_mode != "spatial":
        raise ValueError(f"vv_mode must be 'batch' or 'spatial', got "
                         f"{vv_mode!r}")
    vv_start = L.surgery_vv_start(cfg.vision.layers, surgery_until_layer)
    _, taps = encode_image(vit, cfg, images, out_layers, vv_start=vv_start,
                           policy=policy, act=act, attn_fn=attn_fn,
                           vv_attn_fn=vv_attn_fn, block_fn=block_fn,
                           vv_block_fn=vv_block_fn)
    cd = policy.compute_dtype
    return [L.matmul(L.layer_norm(t[:, 1:, :], vit.ln_post.weight,
                                  vit.ln_post.bias).to(cd),
                     vit.proj.to(cd), policy.precision) for t in taps]

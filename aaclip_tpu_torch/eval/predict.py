"""Batched test-time prediction: images -> (pixel anomaly map, image score).

Adapted image forward -> per-level seg tokens -> ``100 * feats @ anchors``
-> level collapse -> ``M q Mᵀ`` (blur and upsample folded into M, see
ops/similarity.py); the image score comes from the det token.
"""

from __future__ import annotations

from typing import Callable

import torch

from aaclip_tpu_torch.core.config import AdapterConfig, CLIPConfig, DtypePolicy
from aaclip_tpu_torch.core.params import cast_matmul_weights
from aaclip_tpu_torch.device import resolve_device
from aaclip_tpu_torch.models.layers import config_act
from aaclip_tpu_torch.models.vit import VisionTransformer, adapted_forward
from aaclip_tpu_torch.ops.preprocess import (fold_normalization_into_conv1,
                                             patchify_uint8)
from aaclip_tpu_torch.ops.similarity import (apply_postproc_matrix,
                                             collapse_level_scores,
                                             image_score, level_scores)


def make_predict_fn(vit: VisionTransformer, cfg: CLIPConfig,
                    acfg: AdapterConfig, *, img_size: int | None = None,
                    policy: DtypePolicy = DtypePolicy(), attn_fn=None,
                    block_fn=None, uint8_inputs: bool = False, mesh=None,
                    sequence_parallel: bool = False,
                    device=None) -> Callable:
    """``predict(image_adapter, images, anchors, M) -> (pixel_map [B, img,
    img], image_score [B])``, both fp32.

    ``anchors`` is [D, 2] (one class for the batch) or per-sample
    [B, D, 2]; ``M`` is ``fused_postproc_matrix(grid, img, domain)``.
    ``uint8_inputs=True`` takes raw uint8 pixels, with the CLIP
    normalisation folded into the patch-embedding weights. ``attn_fn``
    defaults to the packed-attention kernel (``ops.attention.make_attn_fn``).
    ``block_fn`` replaces every whole block (``ops.fused_block.
    make_block_fn``, the fused-block kernels; ``maybe_make_block_fn`` gives
    it on the card under bf16, None off it and under fp32); it receives
    the block's weights as cast for the predictor.
    ``img_size`` mirrors the JAX signature: the size comes from ``cfg``
    (``get_config(name, img_size)``) and any other value raises.

    ``device=None`` means the card and raises when there is none; ``vit``
    must already live on that device. On the card TF32 is switched off for
    matmuls and cuDNN, so fp32 products are true fp32.
    """
    if mesh is not None or sequence_parallel:
        raise NotImplementedError(
            "meshes, tensor and sequence parallelism are not ported yet: "
            "ROADMAP A12, 'int8, mesh and serving'")
    dev = resolve_device(device)
    param_dev = next(vit.parameters()).device
    if param_dev.type != dev.type:
        raise ValueError(f"vit lives on {param_dev}, predictor built for "
                         f"{dev}")
    if img_size is not None and img_size != cfg.vision.image_size:
        raise ValueError(f"img_size {img_size} does not match the config's "
                         f"{cfg.vision.image_size} (use get_config(name, "
                         f"img_size))")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    visual = cast_matmul_weights(vit, policy)
    act = config_act(cfg, policy)
    patch_embed = None
    if uint8_inputs:
        w_f, b_f = fold_normalization_into_conv1(vit.conv1.weight.t(),
                                                 cfg.vision.patch_size)
        w_f = w_f.to(policy.compute_dtype)

        def patch_embed(images_u8):
            return patchify_uint8(images_u8, w_f, b_f, cfg.vision.patch_size,
                                  compute_dtype=policy.compute_dtype)

    @torch.inference_mode()
    def predict(image_adapter, images, anchors, M):
        images = torch.as_tensor(images, device=dev)
        anchors = torch.as_tensor(anchors, device=dev)
        M = torch.as_tensor(M, device=dev)
        seg, det = adapted_forward(
            visual, image_adapter, cfg, images,
            image_adapt_weight=acfg.image_adapt_weight, levels=acfg.levels,
            proj_relu=acfg.proj_relu, policy=policy, act=act,
            attn_fn=attn_fn, block_fn=block_fn, patch_embed_fn=patch_embed)
        scores = level_scores(torch.stack(seg), anchors)     # [n, B, L, 2]
        _, B, L, _ = scores.shape
        grid = int(round(L ** 0.5))
        q = collapse_level_scores(scores).reshape(B, grid, grid)
        return apply_postproc_matrix(q, M), image_score(det, anchors)

    return predict

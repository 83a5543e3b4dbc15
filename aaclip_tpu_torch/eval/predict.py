"""Batched test-time prediction: images -> (pixel anomaly map, image score).

Adapted image forward -> per-level seg tokens -> ``100 * feats @ anchors``
-> level collapse -> ``M q Mᵀ`` (blur and upsample folded into M, see
ops/similarity.py); the image score comes from the det token.
``run_class_predictions`` drives a loader through the predictor for one
class; ``make_anchor_encoder`` is the text side of the evaluation.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from aaclip_tpu_torch.core.config import AdapterConfig, CLIPConfig, DtypePolicy
from aaclip_tpu_torch.core.params import cast_matmul_weights
from aaclip_tpu_torch.device import resolve_device
from aaclip_tpu_torch.models.layers import config_act
from aaclip_tpu_torch.models.text_model import (TextAdapter, TextTransformer,
                                                adapted_encode_text,
                                                encode_text)
from aaclip_tpu_torch.models.vit import VisionTransformer, adapted_forward
from aaclip_tpu_torch.ops.preprocess import (fold_normalization_into_conv1,
                                             patchify_uint8)
from aaclip_tpu_torch.ops.similarity import (apply_postproc_matrix,
                                             collapse_level_scores,
                                             fused_postproc_matrix,
                                             image_score, level_scores)


def make_features_fn(vit: VisionTransformer, cfg: CLIPConfig,
                     acfg: AdapterConfig, *, img_size: int | None = None,
                     policy: DtypePolicy = DtypePolicy(), attn_fn=None,
                     block_fn=None, uint8_inputs: bool = False, mesh=None,
                     sequence_parallel: bool = False,
                     device=None) -> Callable:
    """``features(image_adapter, images) -> (seg [n_levels, B, L, D],
    det [B, D])``, fp32: the adapted forward that ``make_predict_fn`` scores,
    up to the stacked, L2-normalised seg tokens and the det token (the
    memory bank builds its banks from it). Arguments as
    ``make_predict_fn``'s; ``features.device`` is the device it runs on and
    ``features.pp_precision`` the precision of ``M q Mᵀ`` under ``policy``.
    """
    if mesh is not None or sequence_parallel:
        raise NotImplementedError(
            "meshes, tensor and sequence parallelism are not ported yet: "
            "ROADMAP A12, 'int8, mesh and export'")
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
                                  compute_dtype=policy.compute_dtype,
                                  precision=policy.precision)

    @torch.inference_mode()
    def features(image_adapter, images):
        images = torch.as_tensor(images, device=dev)
        seg, det = adapted_forward(
            visual, image_adapter, cfg, images,
            image_adapt_weight=acfg.image_adapt_weight, levels=acfg.levels,
            proj_relu=acfg.proj_relu, policy=policy, act=act,
            attn_fn=attn_fn, block_fn=block_fn, patch_embed_fn=patch_embed)
        return torch.stack(seg), det

    features.device = dev
    # M q Mᵀ at true fp32 only under precision "highest" (the fp32
    # policy), 3-pass under fp32_high and bf16, as JAX's predictor
    features.pp_precision = "highest" if policy.precision == "highest" \
        else "high"
    return features


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
    the block's weights as cast for the predictor. A staged policy
    (``policy.bf16_until``, fp32_high) runs its first blocks under
    ``policy.prefix_policy()`` with that policy's attention hook, the bf16
    kernel, as JAX's predictor builds it (``models/vit.py::trunk_taps``);
    ``attn_fn`` serves the later blocks.
    ``img_size`` mirrors the JAX signature: the size comes from ``cfg``
    (``get_config(name, img_size)``) and any other value raises.

    ``device=None`` means the card and raises when there is none; ``vit``
    must already live on that device. On the card TF32 is switched off for
    matmuls and cuDNN, so fp32 products are true fp32. The forward is
    ``make_features_fn``'s.
    """
    features = make_features_fn(
        vit, cfg, acfg, img_size=img_size, policy=policy, attn_fn=attn_fn,
        block_fn=block_fn, uint8_inputs=uint8_inputs, mesh=mesh,
        sequence_parallel=sequence_parallel, device=device)
    dev, pp_precision = features.device, features.pp_precision

    @torch.inference_mode()
    def predict(image_adapter, images, anchors, M):
        seg, det = features(image_adapter, images)
        anchors = torch.as_tensor(anchors, device=dev)
        M = torch.as_tensor(M, device=dev)
        scores = level_scores(seg, anchors)                  # [n, B, L, 2]
        _, B, L, _ = scores.shape
        grid = int(round(L ** 0.5))
        q = collapse_level_scores(scores).reshape(B, grid, grid)
        return (apply_postproc_matrix(q, M, pp_precision),
                image_score(det, anchors))

    predict.device = dev
    return predict


def run_class_predictions(predict_fn, image_adapter, loader, anchors,
                          domain: str, img_size: int, grid: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, List[str]]:
    """Drive ``loader``'s batches through ``predict_fn`` (a
    ``make_predict_fn`` predictor) for one class; returns (masks, labels,
    pixel_preds, image_preds, file_names) of the valid samples, as numpy.

    ``M`` and the anchors go to the predictor's device once; the
    predictions stay there until the class ends, so copying them back
    does not wait for each batch."""
    dev = predict_fn.device
    M = torch.from_numpy(fused_postproc_matrix(grid, img_size, domain)).to(dev)
    anchors = torch.as_tensor(anchors).to(dev)
    masks, labels, pix_preds, img_preds, files = [], [], [], [], []
    for batch in loader:
        pix, score = predict_fn(image_adapter,
                                torch.from_numpy(batch["image"]).to(dev),
                                anchors, M)
        n = batch["n_valid"]
        masks.append(batch["mask"][:n])
        labels.append(batch["label"][:n])
        pix_preds.append(pix[:n])
        img_preds.append(score[:n])
        files.extend(batch["file_name"][:n])
    return (np.concatenate(masks), np.concatenate(labels),
            torch.cat(pix_preds).cpu().numpy(),
            torch.cat(img_preds).cpu().numpy(), files)


def make_anchor_encoder(text: TextTransformer, cfg: CLIPConfig,
                        acfg: AdapterConfig,
                        text_adapter: TextAdapter | None = None, *,
                        policy: DtypePolicy = DtypePolicy()) -> Callable:
    """[N, 77] tokens -> [N, D] embeddings for ``encode_dataset_anchors``:
    the adapted text encoder when a text adapter is given, else the frozen
    one (reference test.py:192-200), on a copy of the tower cast as JAX's
    encoder casts it (``cast_matmul_weights``: every block parameter and
    the >= 2-D weights outside the blocks)."""
    text_c = cast_matmul_weights(text, policy)

    @torch.inference_mode()
    def encode(tokens):
        if text_adapter is None:
            return encode_text(text_c, cfg, tokens, policy=policy)
        return adapted_encode_text(
            text_c, text_adapter, cfg, tokens,
            text_adapt_weight=acfg.text_adapt_weight, policy=policy)

    return encode

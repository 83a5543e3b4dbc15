"""Few-shot memory bank: support features and their nearest-neighbour
scores, fused with the text-anchor prediction (the JAX package's
``aaclip_tpu/eval/memory_bank.py``; ``test.py --memory_bank``).

The reference ships only the bank's construction (``get_support_features``,
reference test.py:39-50: the adapted model over the support images, each
level's patch tokens reshaped to ``[-1, D]`` and concatenated over the
images) and never calls it. ``collect_bank`` builds that bank; the scoring
is the JAX package's extension:

* per patch ``100 * (1 - max cosine similarity to the bank) / 2`` per
  level, summed over levels: the scale and level sum of the text path's
  collapse (``ops/similarity.py``), so the two maps fuse on equal footing;
* the pixel map: the fused grid ``(1 - w) * text + w * bank`` through the
  same ``M q Mᵀ`` as the text map;
* the image score: ``(1 - w) * det + w * max(bank grid) / (100 * n)``.

Banks come from the adapters under evaluation, per snapshot and per class.
The maximum runs over chunks of the bank with a running ``torch.maximum``,
so the peak is ``[n, B, L, chunk]`` instead of ``[n, B, L, N]``; the
products are fp32 (TF32 off on the card: JAX's ``precision="highest"``).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from aaclip_tpu_torch.core.config import AdapterConfig, CLIPConfig, DtypePolicy
from aaclip_tpu_torch.eval.predict import make_features_fn
from aaclip_tpu_torch.models.vit import VisionTransformer
from aaclip_tpu_torch.ops.similarity import (apply_postproc_matrix,
                                             collapse_level_scores,
                                             image_score, level_scores)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the memory bank on a mesh is not ported yet: ROADMAP A12, "
            "'int8, mesh and export'")


def make_patch_features_fn(vit: VisionTransformer, cfg: CLIPConfig,
                           acfg: AdapterConfig, *,
                           img_size: int | None = None,
                           policy: DtypePolicy = DtypePolicy(),
                           attn_fn=None, uint8_inputs: bool = False,
                           mesh=None, device=None) -> Callable:
    """``features(image_adapter, images) -> (seg [n, B, L, D], det [B, D])``:
    the adapted forward the predictor scores (``eval/predict.py::
    make_features_fn``), with uint8 inputs and the staged ``bf16_until``
    prefix as there. ``mesh`` other than None raises (ROADMAP A12)."""
    _no_mesh(mesh)
    return make_features_fn(vit, cfg, acfg, img_size=img_size,
                            policy=policy, attn_fn=attn_fn,
                            uint8_inputs=uint8_inputs, device=device)


def collect_bank(features_fn: Callable, image_adapter, support_images,
                 batch_size: int = 8) -> torch.Tensor:
    """Support images [N, C, H, W] -> the per-level bank [n_levels, N * L,
    D] on the features' device: every level's patch tokens of every
    support image, image-major (the reference's bs=1 loop and concat,
    test.py:39-50, in batches of ``batch_size``)."""
    if not isinstance(support_images, torch.Tensor):
        support_images = torch.from_numpy(np.asarray(support_images))
    if support_images.dim() != 4:
        raise ValueError(f"support_images must be [N, C, H, W], got "
                         f"{tuple(support_images.shape)}")
    per_batch = [features_fn(image_adapter,
                             support_images[i:i + batch_size])[0]
                 for i in range(0, support_images.shape[0], batch_size)]
    bank = torch.cat(per_batch, dim=1)           # [n, N_images, L, D]
    n, ni, L, D = bank.shape
    return bank.reshape(n, ni * L, D)


def bank_grid_scores(seg: torch.Tensor, bank: torch.Tensor,
                     chunk: int = 1024) -> torch.Tensor:
    """[n, B, L, D] features x [n, N, D] bank -> [B, L] grid scores:
    per level ``100 * (1 - max_j feat . bank_j) / 2`` (both sides are unit
    vectors), summed over levels. A loop over chunks of ``chunk`` bank rows
    keeps a running maximum; the last chunk is short where JAX pads it
    with the first bank row, which cannot change a maximum."""
    n, B, L, D = seg.shape
    N = bank.shape[1]
    chunk = max(1, min(int(chunk), N))
    feats = seg.float().reshape(n, B * L, D)
    bank = bank.float()
    best = None
    for start in range(0, N, chunk):
        part = bank[:, start:start + chunk]                 # [n, k, D]
        sim = torch.bmm(feats, part.transpose(1, 2)).amax(dim=-1)
        best = sim if best is None else torch.maximum(best, sim)
    return (100.0 * (1.0 - best) / 2.0).sum(0).reshape(B, L)


def make_mb_predict_fn(vit: VisionTransformer, cfg: CLIPConfig,
                       acfg: AdapterConfig, *, img_size: int | None = None,
                       policy: DtypePolicy = DtypePolicy(), attn_fn=None,
                       uint8_inputs: bool = False, bank_weight: float = 0.5,
                       chunk: int = 1024, mesh=None,
                       device=None) -> Callable:
    """``predict(image_adapter, images, anchors, M, bank) -> (pixel_map
    [B, I, I], image_score [B])``: the text-anchor prediction (the ops of
    ``make_predict_fn``, in its order) fused with the bank scores at
    ``bank_weight``; one forward feeds both. At ``bank_weight`` 0 it gives
    ``make_predict_fn``'s output bit for bit. ``predict.features_fn`` builds
    the banks. ``mesh`` other than None raises (ROADMAP A12); a weight
    outside [0, 1] raises ValueError."""
    _no_mesh(mesh)
    w = float(bank_weight)
    if not 0.0 <= w <= 1.0:
        raise ValueError(f"bank_weight must be in [0, 1], got {w}")
    features = make_patch_features_fn(
        vit, cfg, acfg, img_size=img_size, policy=policy, attn_fn=attn_fn,
        uint8_inputs=uint8_inputs, device=device)
    dev, pp_precision = features.device, features.pp_precision

    @torch.inference_mode()
    def predict(image_adapter, images, anchors, M, bank):
        seg, det = features(image_adapter, images)
        anchors = torch.as_tensor(anchors, device=dev)
        M = torch.as_tensor(M, device=dev)
        scores = level_scores(seg, anchors)                  # [n, B, L, 2]
        _, B, L, _ = scores.shape
        grid = int(round(L ** 0.5))
        q_text = collapse_level_scores(scores)               # [B, L]
        q_bank = bank_grid_scores(seg, bank, chunk=chunk)    # [B, L]
        q = ((1.0 - w) * q_text + w * q_bank).reshape(B, grid, grid)
        pix = apply_postproc_matrix(q, M, pp_precision)
        # the bank grid's max rescaled to the det score's [0, 1] (its level
        # sum spans [0, 100 * n_levels])
        s_bank = q_bank.amax(dim=1) / (100.0 * seg.shape[0])
        s = (1.0 - w) * image_score(det, anchors) + w * s_bank
        return pix, s

    predict.features_fn = features
    predict.device = dev
    return predict


def support_records(records, k: int):
    """The first ``k`` normal (label 0) records, in metadata order: the
    deterministic support draw."""
    normals = [r for r in records if r.label == 0]
    if not normals:
        raise ValueError("no normal (label 0) records to build a "
                         "memory bank from")
    return normals[:k]


def collect_support_sets(dataset: str, shot: int, img_size: int, *,
                         uint8: bool = False, log=None) -> dict:
    """``{class: [k, 3, S, S] support images}``: from the dataset's
    ``{shot}-shot`` training metadata where it exists (the reference's
    subsampled few-shot files), else the first ``shot`` normals of the
    full-shot metadata. Classes absent from the metadata are skipped."""
    from aaclip_tpu_torch.data.datasets import (TestDataset, metadata_path,
                                                read_jsonl)
    from aaclip_tpu_torch.data.registry import CLASS_NAMES, DATASETS

    meta = metadata_path(dataset, shot)
    if not os.path.exists(meta):
        meta = metadata_path(dataset, -1)
    if not os.path.exists(meta):
        raise FileNotFoundError(
            f"no train metadata for {dataset!r} (looked for "
            f"{metadata_path(dataset, shot)} and {meta}) — the memory "
            "bank draws support images from training metadata; set "
            "AACLIP_DATA/AACLIP_METADATA on this host")
    records = read_jsonl(meta)
    spec = DATASETS[dataset]
    support = {}
    for class_name in CLASS_NAMES[dataset]:
        cls_records = [r for r in records if r.class_name == class_name]
        if not cls_records:
            continue
        recs = support_records(cls_records, shot)
        sds = TestDataset(spec, recs, img_size, class_name, uint8=uint8)
        support[class_name] = np.stack(
            [sds.get(i)["image"] for i in range(len(sds))])
        if len(recs) < shot and log is not None:
            log.warning("memory_bank: class %s has only %d normal "
                        "training images (< --shot %d)", class_name,
                        len(recs), shot)
    return support

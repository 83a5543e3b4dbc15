"""The anomaly-map tail of the inference path, in fp32.

Per level ``scores = 100 * patch_feats @ anchors`` [B, L, 2]; the test-time
map is the sum over levels of ``(abnormal + 1 - normal) / 2``, blurred and
upsampled. Blur and upsample are linear and identical across levels, so
they fold into ONE matrix ``M = Upsample @ Blur`` [img, grid] applied once
to the level-summed grid map:

    sum_l U B q_l B^T U^T  ==  M (sum_l q_l) M^T

The image score is ``(det . anchors[:, 1] + 1) / 2``. Every product here is
fp32 (the caller keeps TF32 off on the card), but for ``M q Mᵀ`` under the
predictor's fast policies, which takes the 3-pass bf16 product as JAX's
does.

Training upsamples instead the per-level logit difference
``d = abnormal - normal`` with the align-corners bilinear matrix U,
``U d Uᵀ``; the reference's softmax over the two channels is then
``(sigmoid(-d), sigmoid(d))``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aaclip_tpu_torch.models.layers import matmul_3pass
from aaclip_tpu_torch.ops.blur import DOMAIN_BLUR, gaussian_blur_matrix
from aaclip_tpu_torch.ops.resize import bilinear_matrix


def level_scores(seg_tokens: torch.Tensor,
                 anchors: torch.Tensor) -> torch.Tensor:
    """``100 * feats @ anchors`` for stacked levels.

    seg_tokens: [n_levels, B, L, C]; anchors: [B, C, 2] or [C, 2]
    -> [n_levels, B, L, 2]
    """
    feats = seg_tokens.float()
    if anchors.dim() == 2:
        return 100.0 * torch.matmul(feats, anchors.float())
    return 100.0 * torch.einsum("nblc,bck->nblk", feats, anchors.float())


@functools.lru_cache(maxsize=16)
def fused_postproc_matrix(grid: int, img_size: int, domain: str) -> np.ndarray:
    """M = bilinear_upsample(align_corners=True) @ gaussian_blur(reflect),
    [img_size, grid]."""
    k, s = DOMAIN_BLUR[domain]
    B = gaussian_blur_matrix(grid, k, s)
    U = bilinear_matrix(grid, img_size, align_corners=True)
    return (U @ B).astype(np.float32)


def apply_postproc_matrix(q: torch.Tensor, M: torch.Tensor,
                          precision: str = "highest") -> torch.Tensor:
    """[B, g, g] grid maps -> [B, I, I] pixel maps, ``M q Mᵀ``, fp32 out.

    ``precision`` is the JAX package's for these two products: "highest"
    true fp32 (TF32 off on the card), "high" the 3-pass product
    (``matmul_3pass``), which its predictor takes under every policy but
    fp32 (``aaclip_tpu/eval/predict.py:123-126``)."""
    M = M.float()
    if precision == "highest":
        return torch.matmul(torch.matmul(M, q.float()), M.t())
    if precision != "high":
        raise ValueError(f"precision {precision!r}: 'highest' or 'high'")
    Mt = M.t().contiguous()
    # M q = (qᵀ Mᵀ)ᵀ, so both products take M as the 2-D right operand
    out = matmul_3pass(q.float().transpose(1, 2), Mt).transpose(1, 2)
    return matmul_3pass(out, Mt)


def collapse_level_scores(scores: torch.Tensor) -> torch.Tensor:
    """[n_levels, B, L, 2] -> [B, L]: the sum over levels of
    ``(abnormal + 1 - normal) / 2``; the ``+ n/2`` constant folds out of
    the per-level ``+1``s because the rows of M sum to one."""
    n_levels = scores.shape[0]
    return (scores[..., 1] - scores[..., 0]).sum(0) * 0.5 + n_levels * 0.5


def image_score(det: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """``(det . abnormal_anchor + 1) / 2`` per image, fp32."""
    det = det.float()
    if anchors.dim() == 2:
        s = det @ anchors[:, 1].float()
    else:
        s = (det * anchors[:, :, 1].float()).sum(-1)
    return (s + 1.0) / 2.0


def train_similarity_logit(level_score: torch.Tensor,
                           img_size: int) -> torch.Tensor:
    """[B, L, 2] scores of one level -> [B, img, img] upsampled
    (align_corners=True) logit difference ``abnormal - normal``, fp32."""
    B, L, _ = level_score.shape
    grid = int(round(L ** 0.5))
    d = (level_score[..., 1] - level_score[..., 0]).reshape(B, grid, grid)
    U = torch.from_numpy(bilinear_matrix(grid, img_size,
                                         align_corners=True)).to(d.device)
    return apply_postproc_matrix(d, U)


def train_similarity_probs(level_score: torch.Tensor,
                           img_size: int) -> torch.Tensor:
    """The reference-layout [B, 2, img, img] softmax probability maps of
    the training forward: ``(1 - sigmoid(d), sigmoid(d))``."""
    p1 = torch.sigmoid(train_similarity_logit(level_score, img_size))
    return torch.stack([1.0 - p1, p1], dim=1)

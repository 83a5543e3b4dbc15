"""Training losses, in fp32, with the JAX package's numerics
(``aaclip_tpu/ops/losses.py``, after the reference's forward_utils.py and
train.py):

* focal loss: gamma 2, label smoothing 1e-5 by one-hot clamping, on
  probabilities, mean reduction;
* binary dice loss: smooth 1, per-sample flattening;
* seg loss = focal(probs, mask) + dice(p_normal, 1 - mask)
  + dice(p_abnormal, mask);
* image-level cross-entropy on ``det @ anchors`` logits, and the squared
  mean normal/abnormal anchor dot product ("orthogonality").

The fused forms take the upsampled logit-difference map d
(p_abnormal = sigmoid(d)) instead of both probability channels. The
``_masked`` forms average over the valid samples of a padded batch
(``n_valid`` clamped at 1).

Under data parallelism each rank computes its rows' share of the global
batch's loss (``train/steps.py``): the ``_masked`` forms then take
``n_valid``, the global batch's count (summed over the ranks, clamped at
1 after the sum), ``constant=False`` leaves dice's two constant ``1 -``
terms to one rank, and ``reduce`` sums the orthogonality term's
numerator over the ranks before it is squared.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_FOCAL_SMOOTH = 1e-5
_FOCAL_GAMMA = 2.0
_DICE_SMOOTH = 1.0


def focal_loss_probs(probs: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """probs: [B, C, ...spatial]; target: [B, ...spatial] in {0..C-1}."""
    C = probs.shape[1]
    p = torch.movedim(probs, 1, -1).reshape(-1, C).float()
    one_hot = F.one_hot(target.reshape(-1).long(), C).float()
    one_hot = one_hot.clamp(_FOCAL_SMOOTH / (C - 1), 1.0 - _FOCAL_SMOOTH)
    pt = (one_hot * p).sum(1) + _FOCAL_SMOOTH
    return (-((1.0 - pt) ** _FOCAL_GAMMA) * torch.log(pt)).mean()


def _dice_eff(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-sample dice efficiency, [B]."""
    B = p.shape[0]
    pf, tf = p.reshape(B, -1), t.reshape(B, -1)
    inter = (pf * tf).sum(1)
    return (2.0 * inter + _DICE_SMOOTH) / (pf.sum(1) + tf.sum(1)
                                           + _DICE_SMOOTH)


def dice_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """pred/target: [B, ...spatial] soft masks."""
    return 1.0 - _dice_eff(pred.float(), target.float()).mean()


def seg_loss_probs(probs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The reference's seg loss on [B, 2, H, W] probability maps."""
    m = mask.reshape(mask.shape[0], *probs.shape[-2:])
    return (focal_loss_probs(probs, m) + dice_loss(probs[:, 0], 1.0 - m)
            + dice_loss(probs[:, 1], m))


def _focal_terms_from_logit(d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    p1 = torch.sigmoid(d)
    # m >= 1.0 mirrors the reference's int truncation (target.long()): a
    # soft mask value below 1.0 is class 0
    p_t = torch.where(m >= 1.0, p1, 1.0 - p1)
    pt = (1.0 - 2.0 * _FOCAL_SMOOTH) * p_t + 2.0 * _FOCAL_SMOOTH
    return -((1.0 - pt) ** _FOCAL_GAMMA) * torch.log(pt)


def seg_loss_from_logit(d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Seg loss from the logit-difference map d [B, H, W]; ``mask`` has
    d's element count, values in [0, 1]. Equals ``seg_loss_probs`` on
    ``stack([1 - sigmoid(d), sigmoid(d)])``."""
    d = d.float()
    m = mask.reshape(d.shape).float()
    p1 = torch.sigmoid(d)
    focal = _focal_terms_from_logit(d, m).mean()
    return focal + dice_loss(1.0 - p1, 1.0 - m) + dice_loss(p1, m)


def seg_loss_from_logit_masked(d: torch.Tensor, mask: torch.Tensor,
                               valid: torch.Tensor,
                               n_valid: torch.Tensor | None = None,
                               constant: bool = True) -> torch.Tensor:
    """``seg_loss_from_logit`` over the valid samples only; equal to it
    when every sample is valid. ``n_valid`` and ``constant`` as in the
    module's docstring."""
    d = d.float()
    m = mask.reshape(d.shape).float()
    v = valid.float()
    if n_valid is None:
        n_valid = v.sum().clamp_min(1.0)
    per_pixel = _focal_terms_from_logit(d, m)
    focal = (per_pixel * v[:, None, None]).sum() / (
        n_valid * per_pixel.shape[1] * per_pixel.shape[2])
    p1 = torch.sigmoid(d)
    eff0 = _dice_eff(1.0 - p1, 1.0 - m)
    eff1 = _dice_eff(p1, m)
    t0, t1 = (eff0 * v).sum() / n_valid, (eff1 * v).sum() / n_valid
    dice = (1.0 - t0) + (1.0 - t1) if constant else -t0 - t1
    return focal + dice


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0]


def cross_entropy_logits(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy on [B, C] logits and int labels."""
    return _nll(logits, labels).mean()


def cross_entropy_logits_masked(logits: torch.Tensor, labels: torch.Tensor,
                                valid: torch.Tensor,
                                n_valid: torch.Tensor | None = None
                                ) -> torch.Tensor:
    v = valid.float()
    if n_valid is None:
        n_valid = v.sum().clamp_min(1.0)
    return (_nll(logits, labels) * v).sum() / n_valid


def orthogonality_loss(anchors: torch.Tensor) -> torch.Tensor:
    """((normal . abnormal per sample).mean())^2; anchors: [B, C, 2]."""
    dots = (anchors[:, :, 0] * anchors[:, :, 1]).sum(1)
    return dots.mean() ** 2


def orthogonality_loss_masked(anchors: torch.Tensor, valid: torch.Tensor,
                              n_valid: torch.Tensor | None = None,
                              reduce=None) -> torch.Tensor:
    dots = (anchors[:, :, 0] * anchors[:, :, 1]).sum(1)
    v = valid.float()
    if n_valid is None:
        n_valid = v.sum().clamp_min(1.0)
    total = (dots * v).sum()
    if reduce is not None:
        total = reduce(total)
    return (total / n_valid) ** 2

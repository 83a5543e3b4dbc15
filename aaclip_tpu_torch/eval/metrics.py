"""Evaluation metrics: pixel and image AUROC and AP with the reference's
min-max normalisation and domain-dependent image score
(forward_utils.py:233-280), plus AUPRO (the area under the per-region
overlap curve, MVTec-AD protocol), in numpy: the JAX package's numpy path
(``aaclip_tpu/eval/metrics.py``), equal to sklearn's
``roc_auc_score`` / ``average_precision_score``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2


def _binary_clf_curve(labels: np.ndarray, scores: np.ndarray):
    """(fps, tps, thresholds) at each distinct score cut, descending —
    sklearn's internal curve. The order within a run of tied scores does
    not change the cumulative counts at its last element, so the sort
    need not be stable (numpy's default sort is several times faster)."""
    order = np.argsort(-scores)
    scores = scores[order]
    labels = labels[order]
    distinct = np.where(np.diff(scores))[0]
    idxs = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels)[idxs]
    fps = 1 + idxs - tps
    return fps, tps, scores[idxs]


def auroc_ap(labels: np.ndarray, scores: np.ndarray) -> tuple[float, float]:
    """(ROC AUC, AP) from one curve: AUC by trapezoidal integration (==
    sklearn.roc_auc_score), AP = sum (R_i - R_{i-1}) P_i (==
    sklearn.average_precision_score); NaN where undefined."""
    labels = labels.reshape(-1).astype(bool)
    scores = scores.reshape(-1).astype(np.float64)
    fps, tps, _ = _binary_clf_curve(labels, scores)
    if tps[-1] == 0:
        return float("nan"), float("nan")
    recall = tps / tps[-1]
    ap = float(np.sum(np.diff(np.r_[0.0, recall]) * (tps / (tps + fps))))
    if fps[-1] == 0:
        return float("nan"), ap
    auc = float(_trapezoid(np.r_[0.0, recall], np.r_[0.0, fps] / fps[-1]))
    return auc, ap


def aupro(masks: np.ndarray, preds: np.ndarray,
          fpr_limit: float = 0.3) -> float:
    """Area under the per-region-overlap curve up to ``fpr_limit``,
    normalised to [0, 1]; NaN without anomalous or without normal pixels.

    masks: [N, H, W] binary ground truth; preds: [N, H, W] scores. Regions
    are 4-connected components (``scipy.ndimage.label``). Exact over every
    distinct score: sorting all pixels by score, each negative pixel adds
    1/n_neg to the FPR and each pixel of region r adds 1/(|r| n_regions)
    to the PRO; the cumulative sums at the last pixel of each distinct
    score give the curve of the ``>= t`` binarisation, integrated by
    trapezoids to ``fpr_limit`` (interpolated at the limit)."""
    from scipy import ndimage

    masks = masks.reshape(masks.shape[0], *masks.shape[-2:]).astype(bool)
    preds = preds.reshape(preds.shape[0], *preds.shape[-2:]).astype(
        np.float64)
    if not masks.any():
        return float("nan")
    # each region's scores, grouped by one masked gather and a sort of the
    # positive pixels
    regions = []
    for i in range(masks.shape[0]):
        if not masks[i].any():
            continue
        lab, n = ndimage.label(masks[i])
        lab_f = lab.ravel()
        sel = lab_f > 0
        labs_sel = lab_f[sel]
        vals = preds[i].ravel()[sel]
        order = np.argsort(labs_sel, kind="stable")
        counts = np.bincount(labs_sel, minlength=n + 1)[1:]
        regions.extend(np.split(vals[order], np.cumsum(counts)[:-1]))

    neg_scores = preds[~masks].ravel()
    n_neg = neg_scores.size
    n_regions = len(regions)
    if n_neg == 0:
        return float("nan")

    # one sort of the negatives (most pixels), the region pixels merged in
    sn = np.sort(neg_scores)
    reg_all = np.concatenate(regions)
    rw = np.concatenate(
        [np.full(r.size, 1.0 / (r.size * n_regions)) for r in regions])
    o = np.argsort(reg_all, kind="stable")
    rs, rw_s = reg_all[o], rw[o]
    ins = np.searchsorted(sn, rs, side="left")
    s = np.insert(sn, ins, rs)               # all pixels, ascending
    mi = ins + np.arange(rs.size)            # the region pixels in s
    total = s.size
    w_fpr = np.full(total, 1.0 / n_neg)
    w_fpr[mi] = 0.0
    w_pro = np.zeros(total)
    w_pro[mi] = rw_s

    # the curve for descending thresholds
    fpr_c = np.cumsum(w_fpr[::-1])
    pro_c = np.cumsum(w_pro[::-1])
    sd = s[::-1]
    distinct = np.r_[np.where(np.diff(sd))[0], total - 1]
    fprs = np.r_[0.0, fpr_c[distinct]]
    pros = np.r_[0.0, pro_c[distinct]]

    # clip at the limit, interpolating there; when the first distinct
    # threshold already passes it the clipped area is a triangle
    idx = int(np.searchsorted(fprs, fpr_limit, side="right"))
    f, p = fprs[:idx], pros[:idx]
    if f[-1] < fpr_limit and idx < fprs.size:
        w = (fpr_limit - f[-1]) / max(fprs[idx] - f[-1], 1e-12)
        f = np.r_[f, fpr_limit]
        p = np.r_[p, p[-1] + w * (pros[idx] - p[-1])]
    area = _trapezoid(p, f)
    return float(area / fpr_limit)


def _min_max(x: np.ndarray) -> np.ndarray:
    """The reference's normalisation, skipped when ``max == 1``
    (forward_utils.py:241-248)."""
    if x.max() != 1:
        span = x.max() - x.min()
        if span == 0:
            return np.zeros_like(x)
        return (x - x.min()) / span
    return x


def metrics_eval(
    pixel_label: np.ndarray,
    image_label: np.ndarray,
    pixel_preds: np.ndarray,
    image_preds: np.ndarray,
    class_name: str,
    domain: str,
    compute_aupro: bool = False,
) -> Dict[str, float]:
    """One row of the reference's table (forward_utils.py:233-280), in
    points rounded to 0.01, with optional AUPRO. Degenerate label sets (all
    one class) report 0, the reference's image-level convention, for
    pixels too."""
    pixel_preds = _min_max(np.asarray(pixel_preds, np.float64))
    image_preds = _min_max(np.asarray(image_preds, np.float64))

    pmax = pixel_preds.reshape(pixel_preds.shape[0], -1).max(axis=1)
    if domain != "Medical":
        image_preds = pmax * 0.5 + image_preds * 0.5
    else:
        image_preds = pmax

    pl = np.asarray(pixel_label).reshape(-1) != 0
    if pl.any() and not pl.all():
        pixel_auc, pixel_ap = auroc_ap(pl, pixel_preds)
    else:
        pixel_auc = pixel_ap = 0.0

    il = np.asarray(image_label)
    if il.max() != il.min():
        image_auc, image_ap = auroc_ap(il != 0, image_preds)
    else:
        image_auc = image_ap = 0.0

    result = {
        "class name": class_name,
        "pixel AUC": round(pixel_auc, 4) * 100,
        "pixel AP": round(pixel_ap, 4) * 100,
        "image AUC": round(image_auc, 4) * 100,
        "image AP": round(image_ap, 4) * 100,
    }
    if compute_aupro:
        masks3 = np.asarray(pixel_label)
        masks3 = masks3.reshape(masks3.shape[0], *masks3.shape[-2:])
        pro = aupro(masks3, pixel_preds.reshape(masks3.shape))
        result["pixel AUPRO"] = round(pro, 4) * 100 if np.isfinite(pro) \
            else 0.0
    return result

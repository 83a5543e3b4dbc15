"""The port's metrics (``aaclip_tpu_torch/eval/metrics.py``) against the
JAX package's numpy path (its native kernels switched off), on random
arrays with ties and degenerate label sets: AUROC, AP and AUPRO to 1e-12
(the same float64 numpy operations), ``metrics_eval`` rows equal (the
rows are rounded to 0.01 points); AUROC and AP also against sklearn where
it is installed.
"""

import numpy as np
import pytest

from aaclip_tpu import native as jnative
from aaclip_tpu.eval import metrics as jmetrics
from aaclip_tpu_torch.eval import metrics


@pytest.fixture
def jax_numpy_path(monkeypatch):
    monkeypatch.setattr(jnative, "auroc_ap", lambda *a: None)
    monkeypatch.setattr(jnative, "label_components", lambda *a: None)


def _scores(rng, n, ties):
    s = rng.random(n)
    return np.round(s * 20) / 20 if ties else s  # 21 distinct values


@pytest.mark.parametrize("ties", [False, True])
def test_auroc_ap_match_jax_and_sklearn(ties):
    rng = np.random.default_rng(int(ties))
    labels = rng.random(5000) < 0.2
    scores = _scores(rng, 5000, ties) + labels * 0.2
    got = metrics.auroc_ap(labels, scores)
    want = (jmetrics._auroc_numpy(labels, scores),
            jmetrics._ap_numpy(labels, scores))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    sk = pytest.importorskip("sklearn.metrics")
    np.testing.assert_allclose(
        got, (sk.roc_auc_score(labels, scores),
              sk.average_precision_score(labels, scores)), atol=1e-12)


def _case(rng, kind, n=6, h=24):
    masks = np.zeros((n, 1, h, h), np.float32)
    labels = np.zeros(n, np.int32)
    if kind != "all_normal":
        for i in range(n if kind == "all_anomalous" else n // 2):
            y, x, s = rng.integers(0, h - 6), rng.integers(0, h - 6), \
                rng.integers(2, 6)
            masks[i, 0, y:y + s, x:x + s] = 1
            masks[i, 0, (y + 7) % h, (x + 3) % h] = 1  # a second region
            labels[i] = 1
    preds = _scores(rng, n * h * h, kind == "ties").reshape(n, h, h)
    preds = (preds + masks[:, 0] * 0.3).astype(np.float32)
    image = _scores(rng, n, kind == "ties").astype(np.float32)
    return masks, labels, preds, image


@pytest.mark.parametrize("kind", ["random", "ties", "all_normal",
                                  "all_anomalous"])
@pytest.mark.parametrize("domain", ["Industrial", "Medical"])
def test_metrics_eval_matches_jax(jax_numpy_path, kind, domain):
    rng = np.random.default_rng(7)
    masks, labels, preds, image = _case(rng, kind)
    got = metrics.metrics_eval(masks, labels, preds, image, "c", domain,
                               compute_aupro=True)
    want = jmetrics.metrics_eval(masks, labels, preds, image, "c", domain,
                                 compute_aupro=True)
    assert got == want
    if kind in ("all_normal", "all_anomalous"):
        assert got["image AUC"] == got["image AP"] == 0.0
    if kind == "all_normal":
        assert got["pixel AUC"] == got["pixel AUPRO"] == 0.0


@pytest.mark.parametrize("fpr_limit", [0.3, 0.05, 1.0])
def test_aupro_matches_jax(jax_numpy_path, fpr_limit):
    rng = np.random.default_rng(11)
    masks, _, preds, _ = _case(rng, "ties", n=4, h=32)
    got = metrics.aupro(masks[:, 0], preds, fpr_limit)
    want = jmetrics.aupro(masks[:, 0], preds, fpr_limit)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # a plateau over more than the limit of the negatives: the triangle
    flat = np.zeros_like(preds)
    np.testing.assert_allclose(metrics.aupro(masks[:, 0], flat, 0.3),
                               jmetrics.aupro(masks[:, 0], flat, 0.3),
                               atol=1e-12)
    assert np.isnan(metrics.aupro(np.zeros_like(masks[:, 0]), preds))


def test_min_max_rules():
    x = np.array([0.2, 0.6, 1.4])
    np.testing.assert_array_equal(metrics._min_max(x), jmetrics._min_max(x))
    ones = np.array([0.3, 1.0])  # max == 1: left as it is
    assert metrics._min_max(ones) is ones
    np.testing.assert_array_equal(metrics._min_max(np.full(3, 0.5)),
                                  np.zeros(3))

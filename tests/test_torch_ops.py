"""Parity of the port's preprocessing, resize, blur and similarity ops
(aaclip_tpu_torch/ops/) with the JAX package's, on the CPU.

The host-side matrices (bilinear, blur, fused postproc) are the same numpy
code and must be equal. Device ops: fp32 atol 1e-5 rtol 1e-5 (the same
fp32 math in another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.data.transforms import CLIP_MEAN as J_MEAN
from aaclip_tpu.data.transforms import CLIP_STD as J_STD
from aaclip_tpu.ops import blur as jblur
from aaclip_tpu.ops import preprocess as jpre
from aaclip_tpu.ops import resize as jresize
from aaclip_tpu.ops import similarity as jsim
from aaclip_tpu_torch.ops import blur, preprocess, resize, similarity

TOL = dict(atol=1e-5, rtol=1e-5)


def test_clip_constants_are_a_faithful_copy():
    np.testing.assert_array_equal(preprocess.CLIP_MEAN, J_MEAN)
    np.testing.assert_array_equal(preprocess.CLIP_STD, J_STD)
    assert blur.DOMAIN_BLUR == jblur.DOMAIN_BLUR


@pytest.mark.parametrize("n,k,s", [(5, 7, 1.0), (37, 7, 1.0), (37, 9, 1.5),
                                   (1, 7, 1.0), (4, 9, 1.5)])
def test_gaussian_blur_matrix(n, k, s):
    np.testing.assert_array_equal(blur.gaussian_blur_matrix(n, k, s),
                                  jblur.gaussian_blur_matrix(n, k, s))


@pytest.mark.parametrize("args", [(37, 518, True), (5, 70, True),
                                  (4, 56, False), (1, 9, True), (9, 4, True)])
def test_bilinear_matrix(args):
    np.testing.assert_array_equal(resize.bilinear_matrix(*args),
                                  jresize.bilinear_matrix(*args))


@pytest.mark.parametrize("args", [(24, 37), (37, 24), (4, 5), (5, 4),
                                  (7, 7)])
def test_bicubic_matrix(args):
    """The pos-embed resize (antialiased a=-0.5 kernel), up and down."""
    np.testing.assert_array_equal(resize.bicubic_matrix(*args),
                                  jresize.bicubic_matrix(*args))


@pytest.mark.parametrize("domain", ["Industrial", "Medical"])
def test_fused_postproc_matrix(domain):
    np.testing.assert_array_equal(
        similarity.fused_postproc_matrix(37, 518, domain),
        jsim.fused_postproc_matrix(37, 518, domain))


def test_fold_normalization_and_patchify_uint8():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3 * 14 * 14, 32)).astype(np.float32) * 0.05
    u8 = rng.integers(0, 256, (2, 3, 28, 42), dtype=np.uint8)
    jw, jb = jpre.fold_normalization_into_conv1(w, 14)
    tw, tb = preprocess.fold_normalization_into_conv1(torch.from_numpy(w), 14)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7,
                               rtol=1e-6)
    # a sum of 588 fp32 terms in another order
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_array_equal(
        preprocess.extract_patches(torch.from_numpy(u8), 14).numpy(),
        np.asarray(jpre.extract_patches(jnp.asarray(u8), 14)))
    want = jpre.patchify_uint8(jnp.asarray(u8), jw, jb, 14,
                               compute_dtype=jnp.float32,
                               precision="highest")
    got = preprocess.patchify_uint8(torch.from_numpy(u8), tw, tb, 14,
                                    compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    # the fold is exact: uint8 path == normalized-float path
    f = (u8.astype(np.float32) / 255.0 - J_MEAN[None, :, None, None]) \
        / J_STD[None, :, None, None]
    ref = preprocess.patchify(torch.from_numpy(f), torch.from_numpy(w), 14)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("per_sample", [False, True])
def test_level_scores_collapse_postproc_and_image_score(per_sample):
    rng = np.random.default_rng(1)
    n, B, g, C = 3, 2, 5, 32
    feats = rng.standard_normal((n, B, g * g, C)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    det = rng.standard_normal((B, C)).astype(np.float32)
    shape = (B, C, 2) if per_sample else (C, 2)
    anchors = rng.standard_normal(shape).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=-2, keepdims=True)
    M = jsim.fused_postproc_matrix(g, 70, "Industrial")

    js = jsim.level_scores(jnp.asarray(feats), jnp.asarray(anchors))
    ts = similarity.level_scores(torch.from_numpy(feats),
                                 torch.from_numpy(anchors))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    jq = jsim.collapse_level_scores(js).reshape(B, g, g)
    tq = similarity.collapse_level_scores(ts).reshape(B, g, g)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    jpix = jsim.apply_postproc_matrix(jq, jnp.asarray(M))
    tpix = similarity.apply_postproc_matrix(tq, torch.from_numpy(M))
    np.testing.assert_allclose(tpix.numpy(), np.asarray(jpix), **TOL)
    np.testing.assert_allclose(
        similarity.image_score(torch.from_numpy(det),
                               torch.from_numpy(anchors)).numpy(),
        np.asarray(jsim.image_score(jnp.asarray(det), jnp.asarray(anchors))),
        **TOL)
    # the fused map equals the JAX package's whole eval_anomaly_map
    want = jsim.eval_anomaly_map(jnp.asarray(feats), jnp.asarray(anchors),
                                 70, "Industrial")
    np.testing.assert_allclose(tpix.numpy(), np.asarray(want), **TOL)


# The bf16 predict's M q Mᵀ at JAX's precision "high" (F32_AS_3BF16). JAX
# on the CPU ignores "high" and computes fp32, so the reference is a numpy
# emulation of the split: hi = bf16(x), lo = bf16(x - hi), hi·hi + (hi·lo
# + lo·hi) with exact products. The port's fp32 sums in another order:
# 1e-6 of each product's max |value|. Each product is held on its own
# operands: an fp32 ulp of difference in M q can move the split of an
# element, and with it the second product by up to 2^-16 of the value (the
# dropped lo·lo term). Against the exact product the 3-pass result keeps
# JAX's stated ~1e-5 relative, taken of the map's span (chip_smoke.py
# phase 9d holds the card's product to the same bar on [32, 518, 518]).


def _bf16_np(x):
    """Round fp32 to bf16 (nearest, ties to even), as fp32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _mm_3pass_np(a, b):
    ah = _bf16_np(a)
    al = _bf16_np(a - ah)
    bh = _bf16_np(b)
    bl = _bf16_np(b - bh)
    f = np.float64
    return (ah.astype(f) @ bh.astype(f) + (ah.astype(f) @ bl.astype(f)
                                          + al.astype(f) @ bh.astype(f))
            ).astype(np.float32)


def _grid_maps(B, g, seed):
    rng = np.random.default_rng(seed)
    # level-summed scores: 4 levels of (abnormal + 1 - normal) / 2
    return (rng.standard_normal((B, g, g)) * 10 + 2).astype(np.float32)


@pytest.mark.parametrize("g,img,domain", [(37, 518, "Industrial"),
                                          (5, 70, "Medical")])
def test_postproc_3pass_matches_the_hi_lo_emulation(g, img, domain):
    q = _grid_maps(3, g, seed=g)
    M = similarity.fused_postproc_matrix(g, img, domain)
    qt, Mt = torch.from_numpy(q), torch.from_numpy(M)
    # the first product, M q, taken as (qᵀ Mᵀ)ᵀ
    mq = similarity.matmul_3pass(qt.transpose(1, 2),
                                 Mt.t()).transpose(1, 2).numpy()
    want = np.stack([_mm_3pass_np(M, qb) for qb in q])
    assert np.abs(mq - want).max() <= 1e-6 * np.abs(want).max()
    # the whole map: the second product of the first one's result
    got = similarity.apply_postproc_matrix(qt, Mt, "high")
    assert got.dtype == torch.float32 and got.shape == (3, img, img)
    want = np.stack([_mm_3pass_np(o, M.T) for o in mq])
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_postproc_3pass_error_is_jax_s_stated_1e5():
    q = _grid_maps(4, 37, seed=1)
    M = similarity.fused_postproc_matrix(37, 518, "Industrial")
    exact = np.einsum("Ig,bgh,Jh->bIJ", M.astype(np.float64),
                      q.astype(np.float64), M.astype(np.float64))
    high = similarity.apply_postproc_matrix(
        torch.from_numpy(q), torch.from_numpy(M), "high").numpy()
    fp32 = similarity.apply_postproc_matrix(
        torch.from_numpy(q), torch.from_numpy(M), "highest").numpy()
    scale = exact.max() - exact.min()
    assert np.abs(high - exact).max() <= 1e-5 * scale
    assert np.abs(high - fp32).max() <= 1e-5 * scale
    # and it is not the single-pass bf16 product, ~4e-3 relative
    one = np.einsum("Ig,bgh,Jh->bIJ", _bf16_np(M).astype(np.float64),
                    _bf16_np(q).astype(np.float64),
                    _bf16_np(M).astype(np.float64))
    assert np.abs(high - exact).max() < np.abs(one - exact).max() / 10


def test_predict_takes_the_3pass_product_but_under_fp32(monkeypatch):
    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.eval import predict as P

    seen = []

    def recording(q, M, precision="highest"):
        seen.append(precision)
        return similarity.apply_postproc_matrix(q, M, precision)

    monkeypatch.setattr(P, "apply_postproc_matrix", recording)
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1)
    vit = init_vision_params(cfg, device="cpu")
    ad = init_image_adapter(cfg, acfg, device="cpu")
    M = torch.from_numpy(similarity.fused_postproc_matrix(5, 70,
                                                          "Industrial"))
    a = torch.nn.functional.normalize(torch.ones(32, 2), dim=0)
    for policy in (DtypePolicy.fp32(), DtypePolicy.bf16()):
        P.make_predict_fn(vit, cfg, acfg, policy=policy, device="cpu")(
            ad, torch.zeros(1, 3, 70, 70), a, M)
    assert seen == ["highest", "high"]
    with pytest.raises(ValueError, match="precision"):
        similarity.apply_postproc_matrix(M[None, :5], M, "default")

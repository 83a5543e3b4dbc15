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

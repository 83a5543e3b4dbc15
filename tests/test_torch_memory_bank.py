"""The port's few-shot memory bank (``aaclip_tpu_torch/eval/memory_bank.py``)
against the JAX package's (``aaclip_tpu/eval/memory_bank.py``) on the CPU:
tiny-test, fp32, img 70, levels (1, 2), the same weights on both sides
through the weight bridge (``params_from_jax``, ``adapter_from_jax``).

Bars against JAX: the features (stacked seg tokens, det) within atol 1e-5;
the bank (shape and image-major order) within 1e-5; grid scores, maps and
image scores within atol 1e-4 (fp32 through both towers in another
summation order, then the 100x similarity scale). Internal bars, as JAX's
own tests hold JAX's: a bank scanned in chunks of 7 against the whole bank
atol 1e-6; a support image against its own bank < 1e-3; ``bank_weight``
0 against the port's plain predict atol 1e-6. The support draw
(``support_records``, ``collect_support_sets``) bit for bit against JAX's
on the synthetic dataset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.core.params import init_adapter_params
from aaclip_tpu.eval import memory_bank as jmb
from aaclip_tpu.ops.similarity import fused_postproc_matrix
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.core.params import adapter_from_jax, params_from_jax
from aaclip_tpu_torch.eval import memory_bank as mb
from aaclip_tpu_torch.eval.predict import make_predict_fn
from tests.test_torch_layers import perturbed_clip_tree

FEAT_ATOL = 1e-5
ATOL = 1e-4
INTERNAL_ATOL = 1e-6
SELF_SCORE_MAX = 1e-3
LEVELS = dict(levels=(1, 2), image_adapt_until=1)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget_config("tiny-test"), get_config("tiny-test")
    jacfg = JAdapterConfig(**LEVELS, text_adapt_until=1)
    acfg = AdapterConfig(**LEVELS)
    visual = perturbed_clip_tree(jcfg, seed=3)
    jad = jax.tree.map(np.asarray, init_adapter_params(
        jax.random.PRNGKey(4), jcfg, jacfg)["image"])
    vit = params_from_jax(visual, cfg, device="cpu")
    ad = adapter_from_jax(jad, cfg, acfg, device="cpu")
    rng = np.random.default_rng(7)
    S = cfg.vision.image_size
    support = rng.standard_normal((3, 3, S, S)).astype(np.float32)
    test_imgs = rng.standard_normal((4, 3, S, S)).astype(np.float32)
    anchors = rng.standard_normal((cfg.embed_dim, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=0, keepdims=True)
    M = np.asarray(fused_postproc_matrix(cfg.vision.grid, S, "Industrial"))
    jfeats = jmb.make_patch_features_fn({"visual": visual}, jcfg, jacfg)
    feats = mb.make_patch_features_fn(vit, cfg, acfg, policy=DtypePolicy.fp32(),
                                      device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jacfg=jacfg, acfg=acfg, visual=visual,
                jad=jad, vit=vit, ad=ad, support=support, test=test_imgs,
                anchors=anchors, M=M, jfeats=jfeats, feats=feats)


def test_patch_features_match_jax(setup):
    s = setup
    jseg, jdet = s["jfeats"](s["jad"], jnp.asarray(s["test"]))
    seg, det = s["feats"](s["ad"], torch.from_numpy(s["test"]))
    assert seg.shape == (2, 4, 25, 32) and det.shape == (4, 32)
    np.testing.assert_allclose(seg.numpy(), np.asarray(jseg),
                               atol=FEAT_ATOL, rtol=0)
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet),
                               atol=FEAT_ATOL, rtol=0)


def test_collect_bank_matches_jax_order_and_shape(setup):
    s = setup
    jbank = jmb.collect_bank(s["jfeats"], s["jad"], s["support"],
                             batch_size=2)
    bank = mb.collect_bank(s["feats"], s["ad"], s["support"], batch_size=2)
    assert bank.shape == jbank.shape == (2, 3 * 25, 32)
    np.testing.assert_allclose(bank.numpy(), np.asarray(jbank),
                               atol=FEAT_ATOL, rtol=0)
    # image-major: the reference's bs=1 loop, concatenated per level
    rows = [s["feats"](s["ad"], torch.from_numpy(s["support"][i:i + 1]))[0]
            for i in range(3)]
    np.testing.assert_allclose(
        bank.numpy(), torch.cat(rows, 1).reshape(2, -1, 32).numpy(),
        atol=INTERNAL_ATOL, rtol=0)


def test_bank_grid_scores_match_jax(setup):
    s = setup
    jbank = jmb.collect_bank(s["jfeats"], s["jad"], s["support"])
    jseg, _ = s["jfeats"](s["jad"], jnp.asarray(s["test"]))
    bank = mb.collect_bank(s["feats"], s["ad"], s["support"])
    seg, _ = s["feats"](s["ad"], torch.from_numpy(s["test"]))
    want = np.asarray(jmb.bank_grid_scores(jseg, jbank, chunk=16))
    got = mb.bank_grid_scores(seg, bank, chunk=16)
    assert got.shape == (4, 25)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert want.min() > 0.0  # random test images are far from the bank


@pytest.mark.parametrize("weight", [0.5, 1.0])
def test_mb_predict_matches_jax(setup, weight):
    s = setup
    jp = jmb.make_mb_predict_fn({"visual": s["visual"]}, s["jcfg"],
                                s["jacfg"], bank_weight=weight, chunk=16)
    jbank = jmb.collect_bank(jp.features_fn, s["jad"], s["support"])
    jpix, jscore = jp(s["jad"], jnp.asarray(s["test"]),
                      jnp.asarray(s["anchors"]), jnp.asarray(s["M"]), jbank)
    p = mb.make_mb_predict_fn(s["vit"], s["cfg"], s["acfg"],
                              policy=DtypePolicy.fp32(), bank_weight=weight,
                              chunk=16, device="cpu")
    bank = mb.collect_bank(p.features_fn, s["ad"], s["support"])
    pix, score = p(s["ad"], torch.from_numpy(s["test"]),
                   torch.from_numpy(s["anchors"]), torch.from_numpy(s["M"]),
                   bank)
    assert pix.shape == (4, 70, 70) and score.shape == (4,)
    np.testing.assert_allclose(pix.numpy(), np.asarray(jpix), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=ATOL,
                               rtol=0)
    assert 0.0 <= float(score.min()) and float(score.max()) <= 1.0


def test_bank_scores_chunking_exact(setup):
    s = setup
    bank = mb.collect_bank(s["feats"], s["ad"], s["support"])
    seg, _ = s["feats"](s["ad"], torch.from_numpy(s["test"]))
    whole = mb.bank_grid_scores(seg, bank, chunk=bank.shape[1])
    chunked = mb.bank_grid_scores(seg, bank, chunk=7)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(),
                               atol=INTERNAL_ATOL, rtol=0)
    assert float(whole.min()) >= 0.0


def test_self_support_scores_near_zero(setup):
    s = setup
    bank = mb.collect_bank(s["feats"], s["ad"], s["support"])
    seg, _ = s["feats"](s["ad"], torch.from_numpy(s["support"]))
    scores = mb.bank_grid_scores(seg, bank, chunk=7)
    assert float(scores.abs().max()) < SELF_SCORE_MAX


@pytest.mark.parametrize("uint8", [False, True])
def test_weight_zero_equals_plain_predict(setup, uint8):
    s = setup
    imgs = s["test"]
    if uint8:
        imgs = np.random.default_rng(9).integers(
            0, 256, imgs.shape, dtype=np.uint8)
    kw = dict(policy=DtypePolicy.fp32(), uint8_inputs=uint8, device="cpu")
    plain = make_predict_fn(s["vit"], s["cfg"], s["acfg"], **kw)
    p = mb.make_mb_predict_fn(s["vit"], s["cfg"], s["acfg"], bank_weight=0.0,
                              **kw)
    sup = s["support"] if not uint8 else np.random.default_rng(10).integers(
        0, 256, s["support"].shape, dtype=np.uint8)
    bank = mb.collect_bank(p.features_fn, s["ad"], sup)
    args = (torch.from_numpy(imgs), torch.from_numpy(s["anchors"]),
            torch.from_numpy(s["M"]))
    pix0, s0 = plain(s["ad"], *args)
    pix1, s1 = p(s["ad"], *args, bank)
    np.testing.assert_allclose(pix1.numpy(), pix0.numpy(),
                               atol=INTERNAL_ATOL, rtol=0)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), atol=INTERNAL_ATOL,
                               rtol=0)


@pytest.mark.parametrize("weight", [-0.1, 1.5])
def test_bank_weight_outside_unit_interval_raises(setup, weight):
    with pytest.raises(ValueError, match="bank_weight"):
        mb.make_mb_predict_fn(setup["vit"], setup["cfg"], setup["acfg"],
                              bank_weight=weight, device="cpu")


def test_mesh_raises_naming_a12(setup):
    for make in (mb.make_mb_predict_fn, mb.make_patch_features_fn):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            make(setup["vit"], setup["cfg"], setup["acfg"], mesh=object(),
                 device="cpu")


def test_support_records_match_jax():
    from aaclip_tpu.data.datasets import Record as JRecord
    from aaclip_tpu_torch.data.datasets import Record

    rows = [("a.png", 1), ("b.png", 0), ("c.png", 0), ("d.png", 0)]
    for k in (1, 2, 5):
        got = mb.support_records([Record(p, l, "bottle") for p, l in rows],
                                 k)
        want = jmb.support_records([JRecord(p, l, "bottle")
                                    for p, l in rows], k)
        assert [r.image_path for r in got] == [r.image_path for r in want]
    with pytest.raises(ValueError, match="no normal"):
        mb.support_records([Record("a.png", 1, "bottle")], 2)


@pytest.mark.parametrize("shot,uint8", [(2, True), (4, False)])
def test_collect_support_sets_match_jax(tmp_path, monkeypatch, shot, uint8):
    """``shot`` 2 reads the synthetic set's 2-shot metadata; 4 has no
    4-shot file and falls back to the first normals of the full set."""
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset

    data_root, meta_root = make_synthetic_dataset(str(tmp_path), img_px=48,
                                                  n_normal=5)
    monkeypatch.setenv("AACLIP_DATA", data_root)
    monkeypatch.setenv("AACLIP_METADATA", meta_root)
    got = mb.collect_support_sets("MVTec", shot, 70, uint8=uint8)
    want = jmb.collect_support_sets("MVTec", shot, 70, uint8=uint8)
    assert sorted(got) == sorted(want) == ["bottle", "cable"]
    for cls in got:
        assert got[cls].shape == (shot, 3, 70, 70)
        assert got[cls].dtype == want[cls].dtype
        np.testing.assert_array_equal(got[cls], want[cls])

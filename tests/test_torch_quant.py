"""The port's int8 inference (``aaclip_tpu_torch/ops/quant.py``, the int8
branches of ``models/layers.py`` and ``ops/attention.py::make_attn_fn``,
the mixed prefix ``int8_until`` of ``eval/predict.py`` and
``models/vit.py``) against the JAX package's (``aaclip_tpu/ops/quant.py``
and the same branches there) on the CPU, with the same weights on both
sides through the weight bridge (``params_from_jax``).

Bars:
 * ``quantize_weight`` and ``dyn_quant``: bit for bit (the int8 codes and
   the scales);
 * ``qdot``: the int32 accumulators equal, the fp32 outputs within rtol
   1e-6 (the dequant's products in the same order);
 * ``quantize_block_weights(source=)``: the int8 grid of the fp32 leaves
   bit for bit, not that of the bf16 copies;
 * the int8 ``linear`` and ``attention`` (and the ``make_attn_fn`` hook,
   JAX's Pallas kernel in interpret mode) against JAX's on one input: the
   projections' int8 codes are equal, but the attention's fp32 sums in
   another order can move the out-projection's per-token scale and flip
   an int8 rounding, which moves an output by about 1/127 of its row's
   largest input times the weight: within 2e-3 of the output's max;
 * the int8 predict against JAX's int8 predict compiled with XLA's excess
   precision off (``test_torch_train.py::strict``), at the port's bf16
   bar: map correlation > 0.999, scores within 5e-3;
 * the task gate of JAX's ``tests/test_quant.py``, the port's int8 predict
   against its fp32 one: correlation > 0.999, pixel AUROC within 0.002,
   scores within 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.core.params import init_adapter_params
from aaclip_tpu.eval import memory_bank as jmb
from aaclip_tpu.eval.predict import make_predict_fn as j_make_predict_fn
from aaclip_tpu.models import layers as JL
from aaclip_tpu.ops import quant as JQ
from aaclip_tpu.ops.flash_attention import make_attn_fn as j_make_attn_fn
from aaclip_tpu.ops.similarity import fused_postproc_matrix
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.core.params import (adapter_from_jax, params_from_jax)
from aaclip_tpu_torch.eval import memory_bank as mb
from aaclip_tpu_torch.eval.metrics import auroc_ap
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.ops import quant as Q
from aaclip_tpu_torch.ops.attention import make_attn_fn
from tests.test_torch_layers import perturbed_clip_tree
from tests.test_torch_train import strict

QDOT_RTOL = 1e-6
BRANCH_OF_MAX = 2e-3
CORR, SCORE_ATOL, AUROC_TOL = 0.999, 5e-3, 0.002
LEVELS = dict(levels=(1, 2), image_adapt_until=1)
D, H = 64, 4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)])
def test_quantize_weight_matches_jax(shape):
    """JAX's [in, out] weight against the port's [out, in] transpose: the
    same int8 codes and per-output-channel scales."""
    w = np.random.default_rng(0).standard_normal(shape).astype(
        np.float32) * 0.05
    jq, js = JQ.quantize_weight(w)
    q, s = Q.quantize_weight(_t(w).transpose(-1, -2))
    assert q.dtype == torch.int8 and s.shape == js.shape
    np.testing.assert_array_equal(q.transpose(-1, -2).numpy(),
                                  np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dyn_quant_matches_jax(dtype):
    x = np.random.default_rng(1).standard_normal((5, 7, 32)).astype(
        np.float32) * 3.0
    x[0, 0] = 0.0  # an all-zero token: the 1e-12 floor
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    jq, jm = JQ.dyn_quant(jx)
    q, m = Q.dyn_quant(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert np.abs(q.numpy()).max() == 127


def test_qdot_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((33, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.04
    jwq, jws = JQ.quantize_weight(w)
    wq, ws = Q.quantize_weight(_t(w).t())
    jq, _ = JQ.dyn_quant(jnp.asarray(x))
    q, _ = Q.dyn_quant(_t(x))
    acc = np.asarray(jnp.dot(jq, jwq, preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(torch._int_mm(q, wq.t()).numpy(), acc)
    before = Q.qdot.launches
    y = Q.qdot(_t(x), wq, ws)
    assert Q.qdot.launches == before + 1 and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(JQ.qdot(jnp.asarray(x), jwq, jws)),
                               rtol=QDOT_RTOL, atol=0)
    with pytest.raises(TypeError, match="int8"):
        Q.qdot(_t(x), _t(w).t(), ws)


def test_quantize_block_weights_fits_the_fp32_leaves():
    """The predictor casts the tower to bf16 and quantizes from the fp32
    original (``source``): the grid of the fp32 leaves, JAX's
    ``quantize_block_weights(cast, source=orig)``, not of the bf16 copies;
    the float weights are gone and the rest is untouched."""
    cfg = get_config("tiny-test")
    jcfg = jget_config("tiny-test")
    tree = perturbed_clip_tree(jcfg)
    vit = params_from_jax(tree, cfg, device="cpu")
    from aaclip_tpu_torch.core.params import cast_matmul_weights

    cast = cast_matmul_weights(vit, DtypePolicy.int8())
    got = Q.quantize_block_weights(cast.blocks[0], source=vit.blocks[0])
    want = JQ.quantize_block_weights(
        jax.tree.map(lambda a: a[0:1], tree["blocks"]))
    pairs = (("attn", "w_qkv", got.attn, "in_proj_weight"),
             ("attn", "w_out", got.attn.out_proj, "weight"),
             ("mlp", "w_fc", got.mlp.c_fc, "weight"),
             ("mlp", "w_proj", got.mlp.c_proj, "weight"))
    for grp, jname, mod, name in pairs:
        q = getattr(mod, name)
        assert q.dtype == torch.int8 and not q.requires_grad
        np.testing.assert_array_equal(q.t().numpy(),
                                      np.asarray(want[grp][jname][0]))
        np.testing.assert_array_equal(getattr(mod, name + "_s").numpy(),
                                      np.asarray(want[grp][jname + "_s"][0]))
    assert got.attn.in_proj_bias.dtype == torch.bfloat16
    assert got.ln_1.weight.dtype == torch.bfloat16
    # the bf16 copies' grid differs (the double rounding is observable)
    buggy = Q.quantize_block_weights(
        cast_matmul_weights(vit, DtypePolicy.int8()).blocks[0])
    assert any(not torch.equal(getattr(b, n), getattr(g, n))
               for b, g, n in ((buggy.attn, got.attn, "in_proj_weight"),
                               (buggy.mlp.c_fc, got.mlp.c_fc, "weight"),
                               (buggy.mlp.c_proj, got.mlp.c_proj, "weight")))


def _attn_weights(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "w_qkv": rng.standard_normal((D, 3 * D)).astype(np.float32) * 0.05,
        "b_qkv": rng.standard_normal((3 * D,)).astype(np.float32) * 0.01,
        "w_out": rng.standard_normal((D, D)).astype(np.float32) * 0.05,
        "b_out": rng.standard_normal((D,)).astype(np.float32) * 0.01,
    }


def _both_quantized(p):
    """JAX's quantized attention leaves and the port's quantized
    ``PackedAttention`` from the same fp32 weights."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jp["w_qkv"], jp["w_qkv_s"] = JQ.quantize_weight(p["w_qkv"])
    jp["w_out"], jp["w_out_s"] = JQ.quantize_weight(p["w_out"])
    blk = L.ResidualBlock(D)
    with torch.no_grad():
        blk.attn.in_proj_weight.copy_(_t(p["w_qkv"]).t())
        blk.attn.in_proj_bias.copy_(_t(p["b_qkv"]))
        blk.attn.out_proj.weight.copy_(_t(p["w_out"]).t())
        blk.attn.out_proj.bias.copy_(_t(p["b_out"]))
    Q.quantize_block_weights(blk)
    return jp, blk.attn


def test_linear_int8_branch_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    w = rng.standard_normal((D, D)).astype(np.float32) * 0.05
    b = rng.standard_normal((D,)).astype(np.float32) * 0.01
    jwq, jws = JQ.quantize_weight(w)
    want = np.asarray(JL.linear(jnp.asarray(x), {"w": jwq, "w_s": jws,
                                                 "b": jnp.asarray(b)}))
    wq, ws = Q.quantize_weight(_t(w).t())
    got = L.linear(_t(x), wq, _t(b), scale=ws)
    np.testing.assert_allclose(got.numpy(), want, rtol=QDOT_RTOL, atol=0)


@pytest.mark.parametrize("vv", [False, True], ids=["standard", "vv"])
def test_attention_int8_branch_matches_jax(vv):
    x = np.random.default_rng(5).standard_normal((2, 9, D)).astype(
        np.float32)
    jp, attn = _both_quantized(_attn_weights())
    want = np.asarray(JL.attention(jnp.asarray(x), jp, H, vv=vv))
    with torch.no_grad():
        got = L.attention(_t(x), attn, H, vv=vv).numpy()
    np.testing.assert_allclose(got, want,
                               atol=BRANCH_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize("vv", [False, True], ids=["standard", "vv"])
def test_make_attn_fn_int8_matches_jax(vv):
    """The kernel hook's int8 projections around the attention (JAX's
    Pallas kernel in interpret mode, the port's plain version on the
    CPU)."""
    x = np.random.default_rng(6).standard_normal((2, 9, D)).astype(
        np.float32)
    jp, attn = _both_quantized(_attn_weights(7))
    want = np.asarray(j_make_attn_fn(H, JPolicy.fp32(), vv=vv,
                                     interpret=True)(jnp.asarray(x), jp))
    before = Q.qdot.launches
    with torch.no_grad():
        got = make_attn_fn(H, DtypePolicy.fp32(), vv=vv)(_t(x),
                                                         attn).numpy()
    assert Q.qdot.launches == before + 2
    np.testing.assert_allclose(got, want,
                               atol=BRANCH_OF_MAX * np.abs(want).max())


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = jget_config("tiny-test"), get_config("tiny-test")
    jacfg = JAdapterConfig(**LEVELS, text_adapt_until=1)
    acfg = AdapterConfig(**LEVELS)
    visual = perturbed_clip_tree(jcfg, seed=0)
    jad = jax.tree.map(np.asarray, init_adapter_params(
        jax.random.PRNGKey(1), jcfg, jacfg)["image"])
    vit = params_from_jax(visual, cfg, device="cpu")
    ad = adapter_from_jax(jad, cfg, acfg, device="cpu")
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (8, 3, 70, 70), dtype=np.uint8)
    anchors = rng.standard_normal((cfg.embed_dim, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=0, keepdims=True)
    M = np.asarray(fused_postproc_matrix(cfg.vision.grid, 70, "Industrial"))
    return dict(jcfg=jcfg, cfg=cfg, jacfg=jacfg, acfg=acfg, visual=visual,
                jad=jad, vit=vit, ad=ad, u8=u8, anchors=anchors, M=M)


def _port_predict(t, policy, uint8=True):
    p = make_predict_fn(t["vit"], t["cfg"], t["acfg"], policy=policy,
                        uint8_inputs=uint8, device="cpu")
    pix, score = p(t["ad"], torch.from_numpy(t["u8"]),
                   torch.from_numpy(t["anchors"]), torch.from_numpy(t["M"]))
    return pix.numpy(), score.numpy()


def _corr(a, b):
    return np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1]


@pytest.mark.parametrize("until", [0, 1], ids=["whole", "until1"])
def test_int8_predict_matches_strict_jax(tiny, until):
    t = tiny
    jpol = dataclasses.replace(JPolicy.int8(), int8_until=until)
    jp = j_make_predict_fn({"visual": t["visual"]}, t["jcfg"], t["jacfg"],
                           policy=jpol, uint8_inputs=True)
    jpix, jscore = strict(jp.raw, jp.visual, t["jad"], jnp.asarray(t["u8"]),
                          jnp.asarray(t["anchors"]), jnp.asarray(t["M"]))
    before = Q.qdot.launches
    tpix, tscore = _port_predict(
        t, dataclasses.replace(DtypePolicy.int8(), int8_until=until))
    layers = t["cfg"].vision.layers
    assert Q.qdot.launches - before == 4 * (until or layers)
    assert _corr(tpix, np.asarray(jpix)) > CORR
    np.testing.assert_allclose(tscore, np.asarray(jscore), atol=SCORE_ATOL)


def test_int8_predict_tracks_port_fp32(tiny):
    """The task gate of JAX's ``tests/test_quant.py``: int8 maps rank
    pixels as the fp32 ones do."""
    pix_a, score_a = _port_predict(tiny, DtypePolicy.fp32())
    pix_b, score_b = _port_predict(tiny, DtypePolicy.int8())
    assert _corr(pix_a, pix_b) > CORR
    labels = pix_a.reshape(-1) > np.quantile(pix_a, 0.9)
    a32, a8 = (auroc_ap(labels, p.reshape(-1))[0] for p in (pix_a, pix_b))
    assert abs(a32 - a8) < AUROC_TOL, (a32, a8)
    np.testing.assert_allclose(score_b, score_a, atol=SCORE_ATOL)


def test_int8_until_routing_and_range(tiny):
    """int8_until=1 on the 2-layer tower: block 0 holds int8 weights (no
    float copy), block 1 bf16; the mixed predict differs from both the
    bf16 and the whole-int8 predict; out-of-range depths raise."""
    t = tiny
    pol = dataclasses.replace(DtypePolicy.int8(), int8_until=1)
    p = make_predict_fn(t["vit"], t["cfg"], t["acfg"], policy=pol,
                        uint8_inputs=True, device="cpu")
    vis = p.visual
    assert vis["visual.blocks.0.attn.in_proj_weight"].dtype == torch.int8
    assert vis["visual.blocks.0.mlp.c_fc.weight"].dtype == torch.int8
    assert "visual.blocks.0.mlp.c_fc.weight_s" in vis
    assert vis["visual.blocks.1.attn.in_proj_weight"].dtype == torch.bfloat16
    assert "visual.blocks.1.mlp.c_fc.weight_s" not in vis
    # the caller's tower is untouched
    assert t["vit"].blocks[0].attn.in_proj_weight.dtype == torch.float32
    mixed, _ = _port_predict(t, pol)
    for other in (DtypePolicy.bf16(), DtypePolicy.int8()):
        assert np.abs(mixed - _port_predict(t, other)[0]).max() > 1e-6
    for k in (-1, t["cfg"].vision.layers + 1):
        with pytest.raises(ValueError, match="out of range"):
            make_predict_fn(t["vit"], t["cfg"], t["acfg"],
                            policy=dataclasses.replace(DtypePolicy.int8(),
                                                       int8_until=k),
                            device="cpu")


def test_int8_refuses_block_fn_and_the_fused_gate_gives_none(tiny,
                                                            monkeypatch):
    from aaclip_tpu_torch.ops import fused_block

    t = tiny
    with pytest.raises(ValueError, match="block_fn"):
        make_predict_fn(t["vit"], t["cfg"], t["acfg"],
                        policy=DtypePolicy.int8(), device="cpu",
                        block_fn=lambda x, blk: x)
    # the gate as on the card: int8 rides bf16 compute but gets no block
    monkeypatch.setattr(fused_block, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    vitb = get_config("ViT-B-16")
    assert fused_block.maybe_make_block_fn(vitb, DtypePolicy.int8()) is None
    assert fused_block.maybe_make_block_fn(vitb, DtypePolicy.bf16()) \
        is not None


def test_int8_training_refused(tiny):
    from aaclip_tpu_torch.train.optim import make_image_optimizer
    from aaclip_tpu_torch.train.steps import make_stage2_step

    t = tiny
    with pytest.raises(ValueError, match="inference-only"):
        make_stage2_step(t["vit"], t["cfg"], t["acfg"],
                         make_image_optimizer(t["ad"].parameters()),
                         torch.zeros(2, t["cfg"].embed_dim, 2),
                         policy=DtypePolicy.int8(), device="cpu")


def test_int8_memory_bank_predict_matches_jax(tiny):
    """The mb predictor on the int8 trunk against JAX's (strict), at the
    bf16 bars; its bank built from int8 features."""
    t = tiny
    support = t["u8"][:2]
    jpred = jmb.make_mb_predict_fn({"visual": t["visual"]}, t["jcfg"],
                                   t["jacfg"], policy=JPolicy.int8(),
                                   uint8_inputs=True, bank_weight=0.5)
    jbank = jmb.collect_bank(jpred.features_fn, t["jad"],
                             jnp.asarray(support))
    jpix, jscore = strict(jpred.raw, jpred.visual, t["jad"],
                          jnp.asarray(t["u8"]), jnp.asarray(t["anchors"]),
                          jnp.asarray(t["M"]), jbank)
    pred = mb.make_mb_predict_fn(t["vit"], t["cfg"], t["acfg"],
                                 policy=DtypePolicy.int8(),
                                 uint8_inputs=True, bank_weight=0.5,
                                 device="cpu")
    bank = mb.collect_bank(pred.features_fn, t["ad"],
                           torch.from_numpy(support))
    before = Q.qdot.launches
    pix, score = pred(t["ad"], torch.from_numpy(t["u8"]),
                      torch.from_numpy(t["anchors"]),
                      torch.from_numpy(t["M"]), bank)
    assert Q.qdot.launches - before == 4 * t["cfg"].vision.layers
    assert _corr(pix.numpy(), np.asarray(jpix)) > CORR
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore),
                               atol=SCORE_ATOL)


def test_int8_engine_matches_the_jax_int8_engine(tmp_path):
    """``InferenceEngine(precision="int8")``: the port's engine serves the
    int8 trunk (4 int8 products per block) and tracks the JAX package's
    int8 engine, from one checkpoint and adapter directory, at the bf16
    bar on one request."""
    from aaclip_tpu.serve import server as jsrv
    from aaclip_tpu_torch.core.params import adapter_to_jax, \
        init_image_adapter
    from aaclip_tpu_torch.serve import server as psrv
    from aaclip_tpu_torch.train import checkpoint as ckpt
    from tests.test_model_parity import _make_state_dict

    ck = str(tmp_path / "tiny.pt")
    torch.save(_make_state_dict(jget_config("tiny-test", 56), seed=5), ck)
    acfg = dict(**LEVELS, text_adapt_until=1)
    ckpt.save_adapter_checkpoint(
        str(tmp_path / "run" / "image_adapter_1.npz"), 1,
        adapter_to_jax(init_image_adapter(get_config("tiny-test"),
                                          AdapterConfig(**acfg), seed=3,
                                          device="cpu")))
    kw = dict(model_name="tiny-test", img_size=70, datasets=("MVTec",),
              precision="int8", max_batch=1, clip_checkpoint=ck,
              save_path=str(tmp_path / "run"), adapter_cfg=acfg)
    img = np.random.default_rng(9).integers(0, 256, (3, 70, 70),
                                            dtype=np.uint8)
    jeng = jsrv.InferenceEngine(**kw)
    try:
        jmap, jscore = jeng.submit(img, "MVTec", "bottle")
    finally:
        jeng.shutdown()
    eng = psrv.InferenceEngine(**kw, device="cpu")
    try:
        before = Q.qdot.launches
        tmap, tscore = eng.submit(img, "MVTec", "bottle")
        assert Q.qdot.launches - before == 4 * get_config(
            "tiny-test").vision.layers
        assert eng.policy.quant_int8
    finally:
        eng.shutdown()
    assert _corr(np.asarray(tmap), np.asarray(jmap)) > CORR
    assert abs(tscore - float(jscore)) < SCORE_ATOL

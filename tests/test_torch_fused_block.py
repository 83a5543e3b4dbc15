"""The port's fused residual block (aaclip_tpu_torch/ops/fused_block.py)
against the JAX package's (aaclip_tpu/ops/fused_block.py), on the CPU,
where the wrappers run their plain versions and the JAX side runs its
Pallas kernels in interpret mode, at tests/test_fused_block.py's shapes (D
128, F 512, 2 heads, B 2, S 21):

* ``ln_linear``, ``linear_residual`` and ``mlp_fused`` (each activation);
* ``make_block_fn`` in the standard and V-V forms;
* ``encode_image`` with both block overrides, and the predictor with
  ``block_fn``, on a 128-wide 3-layer tower;
* the gate, the wrappers' refusals, their C signatures and the route
  table;
* the plain ``ln_linear`` and ``mlp_fused`` at ViT-B's width (D 768, F
  3072, B 1, S 5), which the bf16 and 3-pass kernels take.

Each under fp32, bf16 and fp32_high (fp32 under precision "high", the
kernels' 3-pass mode; unstaged, ``bf16_until`` 0, so that every product of
the predictor's tower is 3-pass: the staged prefix is
``test_torch_fp32_high.py``'s), the wrappers, the blocks and the
predictor.

The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py (phase 8); here only the arithmetic the kernels copy
and the wrappers' routing are.

fp32 bar: atol = rtol = 2e-5, JAX's own (``test_fused_block.py:51``): the
same fp32 arithmetic in another summation order, and the exact erf against
the TPU kernel's rational erf (|err| <= 1.5e-7). fp32_high holds the same
bar: both sides split every operand into the same bf16 halves and sum the
three exact products in fp32 in another order (JAX's ``(hi.hi + hi.lo) +
lo.hi``, the port's ``hi.hi + (hi.lo + lo.hi)``), plus the rational erf.
Its predictor sits at ``test_torch_fp32_high.py``'s unstaged bars (map
within 5e-5 of its span, scores atol 5e-6): JAX's products outside the
Pallas kernels (the patch embedding, the adapters, the projections) are
XLA dots, which this CPU computes at "high" as true fp32, where the port
runs them 3-pass. bf16 bar: JAX compiled
with XLA's excess precision off (``test_torch_train.strict``) rounds the
normalised rows, the MLP's hidden and the output to bf16 at the points the
port does, and sums in fp32 in another order, so an output rounding may
flip by one bf16 ulp (2^-8 to 2^-7 of the value) and a flipped rounding
inside moves an output by a fraction of that: |d| <= 2^-7 |want| + 2^-8
max |want|.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import CLIPConfig as JCLIPConfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import TextConfig as JTextConfig
from aaclip_tpu.core.config import VisionConfig as JVisionConfig
from aaclip_tpu.core.params import init_adapter_params
from aaclip_tpu.eval.predict import make_predict_fn as j_make_predict_fn
from aaclip_tpu.models import layers as JL
from aaclip_tpu.models import vit as jvit
from aaclip_tpu.ops import fused_block as JFB
from aaclip_tpu.ops.similarity import fused_postproc_matrix
from aaclip_tpu_torch.core.config import (AdapterConfig, CLIPConfig,
                                          DtypePolicy, VisionConfig,
                                          get_config)
from aaclip_tpu_torch.core.params import adapter_from_jax, params_from_jax
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.kernels import build
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.models.vit import encode_image
from aaclip_tpu_torch.ops import fused_block as FB
from aaclip_tpu_torch.ops.attention import attention_packed_plain
from tests.test_torch_layers import perturbed_clip_tree
from tests.test_torch_train import strict

D, F, HEADS = 128, 512, 2
B, S = 2, 21
POLICIES = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
            "bf16": (JPolicy.bf16(), DtypePolicy.bf16()),
            "fp32_high": (JPolicy.fp32_high().unstaged(),
                          DtypePolicy.fp32_high().unstaged())}
FP32_TOL = 2e-5
BF16_REL, BF16_OF_MAX = 2 ** -7, 2 ** -8
HIGH_PIX_SPAN_FRAC, HIGH_SCORE_ATOL = 5e-5, 5e-6
# each policy's own activation, and QuickGELU (the quick_gelu configs)
ACTS = [("fp32", "gelu"), ("fp32", "quick_gelu"), ("bf16", "gelu_tanh"),
        ("bf16", "quick_gelu"), ("fp32_high", "gelu"),
        ("fp32_high", "quick_gelu")]


def block_arrays(seed=0):
    """One block's weights in the JAX layout ([in, out] matrices), numpy
    fp32, no parameter the trivial 0 or 1."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return {"ln_1": {"scale": 1 + n(D, s=0.1), "bias": n(D, s=0.1)},
            "ln_2": {"scale": 1 + n(D, s=0.1), "bias": n(D, s=0.1)},
            "attn": {"w_qkv": n(D, 3 * D), "b_qkv": n(3 * D),
                     "w_out": n(D, D), "b_out": n(D)},
            "mlp": {"w_fc": n(D, F), "b_fc": n(F), "w_proj": n(F, D),
                    "b_proj": n(D)}}


def port_block(p) -> L.ResidualBlock:
    """The same weights in a port ``ResidualBlock`` ([out, in])."""
    blk = L.ResidualBlock(D, F / D).requires_grad_(False)

    def put(param, value):
        param.copy_(torch.from_numpy(np.ascontiguousarray(value)))

    with torch.no_grad():
        put(blk.ln_1.weight, p["ln_1"]["scale"])
        put(blk.ln_1.bias, p["ln_1"]["bias"])
        put(blk.ln_2.weight, p["ln_2"]["scale"])
        put(blk.ln_2.bias, p["ln_2"]["bias"])
        put(blk.attn.in_proj_weight, p["attn"]["w_qkv"].T)
        put(blk.attn.in_proj_bias, p["attn"]["b_qkv"])
        put(blk.attn.out_proj.weight, p["attn"]["w_out"].T)
        put(blk.attn.out_proj.bias, p["attn"]["b_out"])
        put(blk.mlp.c_fc.weight, p["mlp"]["w_fc"].T)
        put(blk.mlp.c_fc.bias, p["mlp"]["b_fc"])
        put(blk.mlp.c_proj.weight, p["mlp"]["w_proj"].T)
        put(blk.mlp.c_proj.bias, p["mlp"]["b_proj"])
    return blk


@pytest.fixture(scope="module")
def data():
    x = np.random.default_rng(1).standard_normal((B, S, D)).astype(np.float32)
    p = block_arrays()
    return x, p, port_block(p)


def inputs(x, policy):
    """x in the policy's compute dtype on both sides."""
    jpol, tpol = POLICIES[policy]
    return (jnp.asarray(x, jpol.compute_dtype),
            torch.from_numpy(x).to(tpol.compute_dtype))


def run_jax(fn, *args):
    """``fn`` jitted and compiled with XLA's excess precision off."""
    return np.asarray(strict(jax.jit(fn), *args), np.float32)


def assert_matches(got: torch.Tensor, want: np.ndarray, policy: str,
                   tol: float = FP32_TOL) -> None:
    got = got.float().numpy()
    assert got.shape == want.shape
    if policy != "bf16":
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    else:
        over = np.abs(got - want) - BF16_REL * np.abs(want)
        assert over.max() <= BF16_OF_MAX * np.abs(want).max(), (
            over.max(), np.abs(want).max())


@pytest.mark.parametrize("section", ["qkv", "value_third"])
@pytest.mark.parametrize("policy", ["fp32", "bf16", "fp32_high"])
def test_ln_linear_matches_jax(data, policy, section):
    x, p, blk = data
    jpol, tpol = POLICIES[policy]
    jx, tx = inputs(x, policy)
    lo = 2 * D if section == "value_third" else 0
    w, b = p["attn"]["w_qkv"][:, lo:], p["attn"]["b_qkv"][lo:]
    want = run_jax(lambda x_: JFB.ln_linear(
        x_, p["ln_1"], w, b, policy=jpol, r_blk=16, f_blk=128,
        interpret=True), jx)
    got = FB.ln_linear(tx, blk.ln_1.weight, blk.ln_1.bias,
                       blk.attn.in_proj_weight[lo:],
                       blk.attn.in_proj_bias[lo:], tpol)
    assert got.dtype == tx.dtype and got.shape == (B, S, 3 * D - lo)
    assert_matches(got, want, policy)


@pytest.mark.parametrize("policy", ["fp32", "bf16", "fp32_high"])
def test_linear_residual_matches_jax(data, policy):
    x, p, blk = data
    jpol, tpol = POLICIES[policy]
    jx, tx = inputs(x, policy)
    jy, ty = inputs(0.3 * x[..., ::-1].copy(), policy)
    want = run_jax(lambda r, y: JFB.linear_residual(
        r, y, p["attn"]["w_out"], p["attn"]["b_out"], policy=jpol, r_blk=16,
        f_blk=128, interpret=True), jx, jy)
    got = FB.linear_residual(tx, ty, blk.attn.out_proj.weight,
                             blk.attn.out_proj.bias, tpol)
    assert got.dtype == tx.dtype
    assert_matches(got, want, policy)


@pytest.mark.parametrize("policy,act", ACTS)
def test_mlp_fused_matches_jax(data, policy, act):
    x, p, blk = data
    jpol, tpol = POLICIES[policy]
    jx, tx = inputs(x, policy)
    want = run_jax(lambda x_: JFB.mlp_fused(
        x_, p["ln_2"], p["mlp"], act=getattr(JL, act), policy=jpol, r_blk=16,
        f_blk=128, interpret=True), jx)
    m = blk.mlp
    got = FB.mlp_fused(tx, blk.ln_2.weight, blk.ln_2.bias, m.c_fc.weight,
                       m.c_fc.bias, m.c_proj.weight, m.c_proj.bias,
                       getattr(L, act), tpol)
    assert got.dtype == tx.dtype
    assert_matches(got, want, policy)


# ViT-B's width (ViT-B-16: D 768, MLP 3072), which the bf16 kernels take:
# one block's LayerNorm, QKV and MLP weights at B 1, S 5.
WD, WF = 768, 3072


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(8)

    def n(*shape, s):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    ln = {"scale": 1 + n(WD, s=0.1), "bias": n(WD, s=0.1)}
    mlp = {"w_fc": n(WD, WF, s=WD ** -0.5), "b_fc": n(WF, s=0.02),
           "w_proj": n(WF, WD, s=WF ** -0.5), "b_proj": n(WD, s=0.02)}
    return (n(1, 5, WD, s=1.0), ln, n(WD, 3 * WD, s=WD ** -0.5),
            n(3 * WD, s=0.02), mlp)


def as_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_ln_linear_matches_jax_at_vit_b_width(wide, policy):
    x, ln, w, b, _ = wide
    jpol, tpol = POLICIES[policy]
    jx, tx = inputs(x, policy)
    want = run_jax(lambda x_: JFB.ln_linear(
        x_, ln, w, b, policy=jpol, r_blk=8, f_blk=768, interpret=True), jx)
    got = FB.ln_linear(tx, as_torch(ln["scale"]), as_torch(ln["bias"]),
                       as_torch(w.T), as_torch(b), tpol)
    assert got.dtype == tx.dtype and got.shape == (1, 5, 3 * WD)
    assert_matches(got, want, policy)


@pytest.mark.parametrize("policy,act", [("fp32", "gelu"),
                                        ("bf16", "gelu_tanh"),
                                        ("fp32_high", "gelu")])
def test_mlp_fused_matches_jax_at_vit_b_width(wide, policy, act):
    x, ln, _, _, mlp = wide
    jpol, tpol = POLICIES[policy]
    jx, tx = inputs(x, policy)
    want = run_jax(lambda x_: JFB.mlp_fused(
        x_, ln, mlp, act=getattr(JL, act), policy=jpol, r_blk=8, f_blk=768,
        interpret=True), jx)
    got = FB.mlp_fused(tx, as_torch(ln["scale"]), as_torch(ln["bias"]),
                       as_torch(mlp["w_fc"].T), as_torch(mlp["b_fc"]),
                       as_torch(mlp["w_proj"].T), as_torch(mlp["b_proj"]),
                       getattr(L, act), tpol)
    assert got.dtype == tx.dtype and got.shape == (1, 5, WD)
    assert_matches(got, want, policy)


@pytest.mark.parametrize("vv", [False, True], ids=["standard", "vv"])
@pytest.mark.parametrize("policy", ["fp32", "bf16", "fp32_high"])
def test_block_fn_matches_jax(data, policy, vv):
    x, p, blk = data
    jpol, tpol = POLICIES[policy]
    jx, tx = inputs(x, policy)
    jfn = JFB.make_block_fn(HEADS, jpol, act=JL.policy_act(jpol), vv=vv,
                            r_blk=16, mlp_f_blk=128, interpret=True)
    want = run_jax(lambda x_: jfn(x_, p), jx)
    fn = FB.make_block_fn(HEADS, tpol, act=L.gelu_tanh if policy == "bf16"
                          else L.gelu, vv=vv)
    got = L.residual_block(tx, blk, HEADS, vv=vv, block_fn=None if vv else fn,
                           vv_block_fn=fn if vv else None)
    assert got.dtype == tx.dtype
    assert_matches(got, want, policy)
    torch.testing.assert_close(got, fn(tx, blk), atol=0, rtol=0)


def small_configs():
    """A 128-wide, 2-head, 3-layer tower at 56 px (grid 4), the JAX and
    the port config of it."""
    jcfg = JCLIPConfig(
        embed_dim=64,
        vision=JVisionConfig(image_size=56, native_image_size=56, layers=3,
                             width=D, heads=HEADS, patch_size=14,
                             output_dim=64),
        text=JTextConfig(context_length=8, vocab_size=32, width=64, heads=2,
                         layers=1, output_dim=64))
    tcfg = CLIPConfig(embed_dim=64, vision=VisionConfig(
        image_size=56, patch_size=14, width=D, layers=3, heads=HEADS))
    return jcfg, tcfg


@pytest.mark.parametrize("fused", [False, True], ids=["hooks", "block_fns"])
def test_encode_image_matches_jax(fused):
    """Blocks 0 standard, 1-2 V-V, taps after blocks 2 and 3, fp32: the
    port with the fused block overrides (or its default kernel hooks)
    against JAX's encode_image with the same."""
    jcfg, tcfg = small_configs()
    visual = perturbed_clip_tree(jcfg, seed=3)
    vit = params_from_jax(visual, tcfg, device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (2, 3, 56, 56)).astype(np.float32)
    jpol, tpol = POLICIES["fp32"]
    jkw, tkw = {}, {}
    if fused:
        jkw = {f"{p}block_fn": JFB.make_block_fn(
            HEADS, jpol, act=JL.gelu, vv=p == "vv_", r_blk=8, mlp_f_blk=128,
            interpret=True) for p in ("", "vv_")}
        tkw = {f"{p}block_fn": FB.make_block_fn(HEADS, tpol, act=L.gelu,
                                                vv=p == "vv_")
               for p in ("", "vv_")}
    jpooled, jtaps = jvit.encode_image(visual, jcfg, jnp.asarray(x), (2, 3),
                                       vv_start=1, policy=jpol, **jkw)
    pooled, taps = encode_image(vit, tcfg, torch.from_numpy(x), (2, 3),
                                vv_start=1, policy=tpol, **tkw)
    assert pooled.shape == (2, 64) and len(taps) == 2
    for got, want in zip((pooled, *taps), (jpooled, *jtaps)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                                   rtol=3e-5)


def test_encode_image_rejects_bad_taps():
    _, tcfg = small_configs()
    vit = params_from_jax(perturbed_clip_tree(small_configs()[0]), tcfg,
                          device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        encode_image(vit, tcfg, torch.zeros(1, 3, 56, 56), (4,))


@pytest.mark.parametrize("policy", ["fp32", "bf16", "fp32_high"])
def test_predict_with_block_fn_matches_jax(policy):
    """The predictor with the fused block on the 128-wide tower against
    JAX's with its fused block (interpret mode); bf16 with uint8 inputs.
    The map and the scores are held at the block's bars carried through
    three blocks, the projections and the 100x similarity: fp32 atol 1e-4,
    rtol 1e-5 (the predictor's bar in test_torch_model.py); bf16 within
    1e-2 of the map's span, scores atol 5e-3 (chip_smoke.py's predict
    bars); fp32_high the unstaged bars of test_torch_fp32_high.py (see
    the module docstring)."""
    jcfg, tcfg = small_configs()
    jpol, tpol = POLICIES[policy]
    levels = dict(levels=(2, 3), image_adapt_until=1)
    jacfg = JAdapterConfig(**levels, text_adapt_until=1)
    visual = perturbed_clip_tree(jcfg, seed=5)
    jad = jax.tree.map(np.asarray, init_adapter_params(
        jax.random.PRNGKey(6), jcfg, jacfg)["image"])
    tacfg = AdapterConfig(**levels)
    vit = params_from_jax(visual, tcfg, device="cpu")
    tad = adapter_from_jax(jad, tcfg, tacfg, device="cpu")
    rng = np.random.default_rng(7)
    uint8 = policy == "bf16"
    if uint8:
        x = rng.integers(0, 256, (2, 3, 56, 56), dtype=np.uint8)
    else:
        x = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    anchors = rng.standard_normal((64, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=0, keepdims=True)
    M = fused_postproc_matrix(4, 56, "Industrial")
    jblock = JFB.make_block_fn(HEADS, jpol, act=JL.config_act(jcfg, jpol),
                               r_blk=32, mlp_f_blk=128, interpret=True)
    jp = j_make_predict_fn({"visual": visual}, jcfg, jacfg, policy=jpol,
                           uint8_inputs=uint8, block_fn=jblock)
    jpix, jscore = (np.asarray(a) for a in strict(
        jp.raw, jp.visual, jad, jnp.asarray(x), jnp.asarray(anchors),
        jnp.asarray(M)))
    block_fn = FB.make_block_fn(HEADS, tpol, act=L.config_act(tcfg, tpol))
    tp = make_predict_fn(vit, tcfg, tacfg, policy=tpol, uint8_inputs=uint8,
                         block_fn=block_fn, device="cpu")
    pix, score = (t.numpy() for t in tp(tad, torch.from_numpy(x),
                                        torch.from_numpy(anchors),
                                        torch.from_numpy(M)))
    assert pix.shape == (2, 56, 56) and score.shape == (2,)
    if policy == "fp32":
        np.testing.assert_allclose(pix, jpix, atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(score, jscore, atol=1e-4, rtol=1e-5)
    elif policy == "fp32_high":
        span = jpix.max() - jpix.min()
        assert np.abs(pix - jpix).max() <= HIGH_PIX_SPAN_FRAC * span
        np.testing.assert_allclose(score, jscore, atol=HIGH_SCORE_ATOL)
    else:
        span = jpix.max() - jpix.min()
        assert np.abs(pix - jpix).max() <= 1e-2 * span
        np.testing.assert_allclose(score, jscore, atol=5e-3)


def test_gate_and_supported_geometry(monkeypatch):
    """ViT-L's geometry is supported under bf16 and fp32, ViT-B-16's (width
    768) too (every route is the one engine's, widths a multiple of 128),
    tiny-test's (width 64) under neither. Off the card the gate
    gives no block; on the card it gives one under bf16 only, None under
    fp32 as JAX's gate does, None where JAX's gate refuses the geometry
    (tiny-test's 4 heads of 16), and a bf16 geometry that JAX's gate
    admits and the kernels do not take (width 1280 in heads of 128: the
    LayerNorm GEMMs reduce at most 1024 columns) raises instead of
    falling back."""
    import dataclasses

    vit_l, tiny = get_config("ViT-L-14-336"), get_config("tiny-test")
    vit_b = [get_config(n) for n in ("ViT-B-16", "ViT-B-16-quickgelu")]
    bf16, fp32 = DtypePolicy.bf16(), DtypePolicy.fp32()
    for policy in (bf16, fp32):
        assert FB.fused_block_supported(vit_l, policy)
        assert FB.fused_block_supported(small_configs()[1], policy)
        assert not FB.fused_block_supported(tiny, policy)
        assert FB.maybe_make_block_fn(vit_l, policy, device="cpu") is None
    for cfg in vit_b:
        assert cfg.vision.width == 768 and cfg.vision.head_dim == 64
        assert FB.fused_block_supported(cfg, bf16)
        assert FB.fused_block_supported(cfg, fp32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FB.maybe_make_block_fn(vit_l, bf16)
    monkeypatch.setattr(FB, "resolve_device",
                        lambda device: torch.device("cuda"))
    assert FB.maybe_make_block_fn(tiny, bf16) is None
    wide = dataclasses.replace(vit_l, vision=dataclasses.replace(
        vit_l.vision, width=1280, heads=10))
    assert FB.reference_gate(wide)
    assert not FB.fused_block_supported(wide, bf16)
    with pytest.raises(ValueError, match="no kernels for width 1280"):
        FB.maybe_make_block_fn(wide, bf16)
    assert FB.maybe_make_block_fn(wide, fp32) is None
    for cfg in (vit_l, *vit_b):
        assert callable(FB.maybe_make_block_fn(cfg, bf16))
        assert callable(FB.maybe_make_block_fn(cfg, bf16, vv=True))
        assert FB.maybe_make_block_fn(cfg, fp32) is None
    assert FB.maybe_make_block_fn(tiny, fp32) is None


def test_width_checks_match_the_kernel_tiles():
    """The wrappers' width checks read the tiles fused_block.cu is
    instantiated for: the bf16 GEMM's 64-column reduction tile (one
    128-byte TMA row) and its output tiles of 128 and 256 columns (every N
    the check admits has a tile), the same GEMM's split-plane modes (3-pass
    and 6-pass) at 128 columns, and the LayerNorm cap."""
    import re

    src = (build.CSRC / "fused_block.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    engine = (const("kBN"), const("kBK"))
    assert FB._GEMM_TILES == {FB.BF16: engine, FB.HIGH: engine,
                              FB.FP32: engine}
    assert (const("kBK"), const("kBN"), const("kBNWide")) == (64, 128, 256)
    assert "float acc[kBN / 2], part[kBN / 2];" in src  # split: 128 wide
    assert FB.KERNEL_MAX_K == const("kMaxK") == 1024
    bf16, fp32, high = FB.BF16, FB.FP32, FB.HIGH
    for key in (bf16, high, fp32):  # the engine's widths, in every mode
        assert FB._gemm_widths_ok(key, 3072, 1024)
        assert not FB._gemm_widths_ok(key, 3072, 2048)
        assert FB._gemm_widths_ok(key, 1024, 4096, ln=False)
        assert not FB._gemm_widths_ok(key, 192, 1024)
        assert FB._mlp_widths_ok(key, 768, 3072)
        assert FB._mlp_widths_ok(key, 1024, 4096)
        assert not FB._mlp_widths_ok(key, 768, 3136)
    assert FB._gemm_widths_ok(bf16, 3072, 1024)
    assert FB._gemm_widths_ok(bf16, 384, 128)
    assert not FB._gemm_widths_ok(bf16, 3072, 2048)  # LN row over the cap
    assert FB._gemm_widths_ok(bf16, 1024, 4096, ln=False)  # proj, K = F
    assert not FB._gemm_widths_ok(bf16, 1024, 96, ln=False)
    assert not FB._gemm_widths_ok(bf16, 192, 1024)
    assert FB._gemm_widths_ok(fp32, 1024, 4096, ln=False)
    assert FB._mlp_widths_ok(bf16, 768, 3072)
    assert FB._mlp_widths_ok(bf16, 128, 512)
    assert not FB._mlp_widths_ok(bf16, 1280, 5120)
    assert not FB._mlp_widths_ok(bf16, 768, 3136)
    assert FB._mlp_widths_ok(fp32, 768, 3072)
    assert FB._mlp_widths_ok(fp32, 1024, 4096)


def test_routes_match_the_kernel_sources():
    """The route table is the source's own: the wrappers' mode codes are
    the source's; each C entry point sends kModeF32 (fp32 under "highest")
    to the 6-pass mode of the TMA + wgmma GEMM (three planes) and
    kMode3Pass (fp32 under "high") to its 3-pass mode (two planes), each
    after the splits into planes, and kModeBf16 to the bf16 GEMM after the
    row statistics where there is a LayerNorm, in that order; every
    __global__ kernel of the source is one of the three routes'."""
    import re

    src = (build.CSRC / "fused_block.cu").read_text()
    assert FB.TMA_ROUTES == {FB.BF16, FB.HIGH, FB.FP32}
    assert FB.BF16 == FB.route(torch.bfloat16, "high") == (torch.bfloat16,
                                                           None)
    assert FB.FP32 == FB.route(torch.float32, None) == \
        FB.route(torch.float32, "highest")
    modes = {name: int(v) for name, v in
             re.findall(r"\b(kMode\w+) = (\d+)", src)}
    assert FB._MODES == {FB.FP32: modes["kModeF32"],
                         FB.BF16: modes["kModeBf16"],
                         FB.HIGH: modes["kMode3Pass"]}

    def body(start):
        start = src.index(start)
        return src[start:src.index("\n}\n", start)]

    # each entry point's split-plane route and its launches, in order
    planes = {"aaclip_ln_linear": ("ln_linear_planes", [
                  "launch_split<kP>(", "launch_ln_split<kP>(",
                  "launch_planes_gemm<kP, kEpiBias>"]),
              "aaclip_linear_residual": ("linear_residual_planes", [
                  "launch_split<kP>(",
                  "launch_planes_gemm<kP, kEpiResidual>"]),
              "aaclip_mlp_fused": ("mlp_planes", [
                  "launch_split<kP>(", "launch_ln_split<kP>(",
                  "launch_planes_gemm<kP, kEpiAct>",
                  "launch_planes_gemm<kP, kEpiProj>"])}
    tma = {"aaclip_ln_linear": ["launch_stats(", "launch_tma_gemm<true, "
                                "kEpiBias>"],
           "aaclip_linear_residual": ["launch_tma_gemm<false, kEpiResidual>"],
           "aaclip_mlp_fused": ["launch_stats(", "launch_tma_gemm<true, "
                                "kEpiAct>", "launch_tma_gemm<false, kEpiProj>"]}
    for entry in tma:
        b = body(f'extern "C" int {entry}(')
        route, launches = planes[entry]
        calls = ["if (mode == kModeF32)", f"return {route}<3>(",
                 "if (mode == kMode3Pass)", f"return {route}<2>("] + \
            tma[entry]
        positions = [b.index(c) for c in calls]
        assert positions == sorted(positions), entry  # in launch order
        assert "launch_tma_gemm" not in b[:b.index(tma[entry][0])]
        r = body(f"int {route}(")
        positions = [r.index(c) for c in launches]
        assert positions == sorted(positions), route
        assert "launch_tma_gemm" not in r and "launch_stats" not in r
    kernels = set(re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", src))
    assert kernels == {"row_stats_kernel", "gemm_wgmma", "split_kernel",
                       "ln_split_kernel", "gemm_planes_wgmma"}


def test_wrappers_refuse_inputs_that_require_grad(data):
    _, _, blk = data
    x = torch.zeros(1, 3, D, requires_grad=True)
    m = blk.mlp
    calls = {
        "ln_linear": lambda: FB.ln_linear(x, blk.ln_1.weight, blk.ln_1.bias,
                                          blk.attn.in_proj_weight,
                                          blk.attn.in_proj_bias),
        "linear_residual": lambda: FB.linear_residual(
            x, x, blk.attn.out_proj.weight, blk.attn.out_proj.bias),
        "mlp_fused": lambda: FB.mlp_fused(
            x, blk.ln_2.weight, blk.ln_2.bias, m.c_fc.weight, m.c_fc.bias,
            m.c_proj.weight, m.c_proj.bias, L.gelu),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call()
        with torch.no_grad():
            assert call().shape[:2] == (1, 3)


def test_wrappers_run_plain_on_cpu_and_count_no_launch(data):
    x, _, blk = data
    tx = torch.from_numpy(x)
    before = (FB.ln_linear.launches, FB.linear_residual.launches,
              FB.mlp_fused.launches)
    policy = DtypePolicy.fp32()
    fused = FB.make_block_fn(HEADS, policy, act=L.gelu)
    plain = FB.make_block_fn(HEADS, policy, act=L.gelu,
                             ln=FB.ln_linear_plain,
                             attention=attention_packed_plain,
                             residual=FB.linear_residual_plain,
                             mlp=FB.mlp_fused_plain)
    torch.testing.assert_close(fused(tx, blk), plain(tx, blk), atol=0,
                               rtol=0)
    assert before == (FB.ln_linear.launches, FB.linear_residual.launches,
                      FB.mlp_fused.launches)


def test_wrappers_refuse_other_devices(data):
    blk = copy.deepcopy(data[2]).to("meta")
    x = torch.empty(1, 3, D, device="meta")
    with pytest.raises(ValueError, match="ln_linear: unsupported device"):
        FB.ln_linear(x, blk.ln_1.weight, blk.ln_1.bias,
                     blk.attn.in_proj_weight, blk.attn.in_proj_bias)
    with pytest.raises(ValueError, match="mlp_fused: unsupported device"):
        m = blk.mlp
        FB.mlp_fused(x, blk.ln_2.weight, blk.ln_2.bias, m.c_fc.weight,
                     m.c_fc.bias, m.c_proj.weight, m.c_proj.bias, L.gelu)


def test_masked_block_refuses_a_block_override(data):
    x, _, blk = data
    with pytest.raises(ValueError, match="unmasked"):
        L.residual_block(torch.from_numpy(x), blk, HEADS,
                         mask=L.causal_mask(S),
                         block_fn=FB.make_block_fn(HEADS, act=L.gelu))


@pytest.mark.parametrize("entry,n_params", [("aaclip_ln_linear", 15),
                                            ("aaclip_linear_residual", 12),
                                            ("aaclip_mlp_fused", 19),
                                            ("aaclip_gemm_tile_width", 1)])
def test_entry_points_match_the_c_signatures(entry, n_params):
    """The ctypes argument lists in ops/fused_block.py have one entry per
    parameter of each C entry point in fused_block.cu: the route's mode,
    ``ln_linear`` with the row statistics' mean and rstd scratch and the
    split planes of the rows and of W, ``linear_residual`` with the
    planes of y and W, ``mlp_fused`` with the statistics, the hidden (bf16,
    or its planes) and the planes of the rows and of both weights, and
    the bf16 GEMM's tile-width override."""
    import re

    src = (build.CSRC / "fused_block.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    code = (build.CSRC.parent.parent / "ops" / "fused_block.py").read_text()
    argtypes = re.search(rf"lib\.{entry}\.argtypes = \[([^\]]*)\]", code)
    assert len(sig.split(",")) == len(argtypes.group(1).split(",")) \
        == n_params
    assert "fused_block" in build.KERNELS


@pytest.mark.parametrize("name", build.KERNELS)
def test_every_launch_site_counts_itself(name):
    """Each source counts its kernel launches for ``build.kernels_launched``
    (the per-call counts of chip_smoke.py): it includes launch_count.cuh
    and every ``<<<...>>>`` launch is followed by ``note_launch()``."""
    import re

    src = (build.CSRC / f"{name}.cu").read_text()
    assert '#include "launch_count.cuh"' in src
    launches = src.count(">>>(")
    assert launches >= 2
    assert len(re.findall(r">>>\([^;]*\);\s*note_launch\(\);", src)) \
        == launches == src.count("note_launch();")
    header = (build.CSRC / "launch_count.cuh").read_text()
    assert 'extern "C" long long aaclip_kernels_launched()' in header

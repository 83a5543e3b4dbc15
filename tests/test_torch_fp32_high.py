"""The fp32_high precision policy in the port (``DtypePolicy.fp32_high``:
3-pass products, the bf16-staged prefix of the vision trunk, the 3-pass
mode of the attention kernels) against the JAX package's, on the CPU.

JAX on this CPU computes an XLA dot at precision "high" as true fp32, so
its one real 3-pass reference is the Pallas kernels' ``_kdot`` in
interpret mode: the JAX side runs fp32_high with ``make_attn_fn(...,
interpret=True)``. The port runs every fp32 product 3-pass (``matmul``),
so where JAX's side is XLA the two differ by the 3-pass error itself.

Bars:
* the policy table, ``prefix_policy`` and ``unstaged``: equal to JAX's.
* ``matmul_3pass`` / 3-pass ``linear``, forward and both gradients,
  against a numpy emulation of hi·hi + (hi·lo + lo·hi) on the fp32 operands
  and the fp32 cotangent (exact products, fp64 sums): 1e-6 of the result's
  max |value| (fp32 sums in another order).
* the plain 3-pass attention (B1 packed, B3 V-V, B4 on [B, H, S, hd])
  against JAX's ``attention_packed`` / ``attention_kernel`` at
  ``precision="high"`` in interpret mode, head dims 64 and 16, ragged
  valid_len: atol 1e-5, rtol 1e-5 (both split identically; read: at most
  3.3e-6); and nearer JAX's 3-pass than its own fp32 form is (read: 1/4
  to 1/8 of that distance), so the mode is not the fp32 one. B2 against
  ``jax.vjp`` of the Pallas custom VJP at "high": 3e-5 of each gradient's
  max (read: at most 1.13e-5, where dP - dsum cancels).
* tiny-test predict, ``bf16_until`` 0, against JAX's with the interpret
  kernel: the map within 5e-5 of its span and the scores within 5e-6
  (read: 8.3e-6 of the span, 4.2e-7; the gap is the port's 3-pass GEMMs
  against JAX's fp32 ones, and the port's own fp32 predict lies as far);
  ``bf16_until`` 1 (block 0 at bf16): the bf16 bars of
  ``test_torch_model.py``, map correlation > 0.999 and scores atol 5e-3
  (read: 1 - 7e-7 and 3.5e-5). The staged trunk under remat equals the
  unrematerialised one bit for bit.
* tiny-test stage-2 step (the kernel's differentiable path in interpret
  mode on JAX's side): losses rtol 1e-5 over 5 Adam steps and adapters
  atol 1e-5 after steps 1 and 5 (read: 1.6e-6, none left out), one
  step's gradients within 1e-4 of each leaf's max (read: 2.3e-5).
* tiny-test stage 1: features atol 5e-5 in both V-V modes (read: 9.5e-6);
  the step's losses rtol 5e-5 over 5 steps and the text adapters atol
  4e-5 (read: 1.15e-5 and 7.8e-6; JAX's text tower is XLA, true fp32
  here), one step's gradients within 6e-5 of each leaf's max (read:
  1.2e-5).
* ``make_block_fn`` under "high" builds the fused block on the kernels'
  3-pass mode (its arithmetic against JAX's Pallas kernels is
  ``test_torch_fused_block.py``'s), and ``maybe_make_block_fn`` gives
  None, as JAX's gate admits bf16 alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.eval.predict import make_predict_fn as j_make_predict_fn
from aaclip_tpu.ops.flash_attention import attention_kernel as \
    j_attention_kernel
from aaclip_tpu.ops.flash_attention import attention_packed as j_attention
from aaclip_tpu.ops.flash_attention import attention_packed_diff as j_diff
from aaclip_tpu.ops.flash_attention import make_attn_fn as j_make_attn_fn
from aaclip_tpu.ops.similarity import fused_postproc_matrix
from aaclip_tpu.train import optim as joptim
from aaclip_tpu.train.steps import stage1_features_fn as j_features_fn
from aaclip_tpu_torch.core.config import DtypePolicy, get_config
from aaclip_tpu_torch.core.params import text_adapter_to_jax
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.models.vit import staged_depth
from aaclip_tpu_torch.ops import attention as A
from aaclip_tpu_torch.ops import fused_block as FB
from aaclip_tpu_torch.train.steps import stage1_features_fn
from tests.test_torch_attention import packed_qkv
from tests.test_torch_model import TINY_LEVELS, both_models
from tests.test_torch_ops import _bf16_np
from tests.test_torch_stage1 import (Stage1Case, batch, jax_stage1,
                                     port_stage1)
from tests.test_torch_train import (assert_adapter_close, grad_capture,
                                    grads_as_jax, jax_step, port_step,
                                    step_case)

HIGH = "high"


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- policy

def _fields(p):
    name = getattr(p.compute_dtype, "__name__", str(p.compute_dtype))
    return (name.split(".")[-1], p.fast_act, p.precision, p.bf16_until)


@pytest.mark.parametrize("name", ["fp32", "fp32_high", "bf16"])
def test_fp32_high_policy_table_matches_jax(name):
    """Each policy, its prefix policy and its unstaged form, field for
    field against JAX's (param dtype aside: the port stores fp32)."""
    j, p = JPolicy.from_name(name), DtypePolicy.from_name(name)
    assert _fields(p) == _fields(j)
    assert _fields(p.prefix_policy()) == _fields(j.prefix_policy())
    assert _fields(p.unstaged()) == _fields(j.unstaged())
    if not p.bf16_until:
        assert p.unstaged() is p
    # positional constructions of the two first fields keep working
    assert DtypePolicy(p.compute_dtype, p.fast_act).precision == "highest"


def test_fp32_high_stages_six_blocks_of_the_trunk_only_in_fp32():
    high = DtypePolicy.fp32_high()
    assert (high.compute_dtype, high.precision, high.bf16_until,
            high.fast_act) == (torch.float32, "high", 6, False)
    assert staged_depth(high, 24) == 6 and staged_depth(high, 2) == 2
    assert staged_depth(high.unstaged(), 24) == 0
    bf16 = dataclasses.replace(DtypePolicy.bf16(), bf16_until=4)
    assert staged_depth(bf16, 24) == 0  # a 2-byte policy is not staged
    assert L.config_act(get_config("tiny-test"),
                        high.prefix_policy()) is L.gelu


# ------------------------------------------------------- 3-pass products

def _mm_3pass_np(a, b):
    """hi·hi + (hi·lo + lo·hi) of the bf16 halves, exact products and
    fp64 sums, as fp32."""
    ah, bh = _bf16_np(a), _bf16_np(b)
    al, bl = _bf16_np(a - ah), _bf16_np(b - bh)
    f = np.float64
    return (ah.astype(f) @ bh.astype(f) + (ah.astype(f) @ bl.astype(f)
                                          + al.astype(f) @ bh.astype(f))
            ).astype(np.float32)


def _close(got, want, frac=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert np.abs(got - want).max() <= frac * np.abs(want).max()


def test_fp32_high_linear_and_its_gradients_are_3pass():
    """``layers.linear`` under fp32_high: the forward and dx, dW each the
    3-pass product, the cotangent split in fp32 (not rounded to bf16)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    w = (0.1 * rng.standard_normal((80, 96))).astype(np.float32)
    b = rng.standard_normal(80).astype(np.float32)
    g = rng.standard_normal((3, 5, 80)).astype(np.float32)
    xt, wt, bt = (t(v).requires_grad_() for v in (x, w, b))
    y = L.linear(xt, wt, bt, DtypePolicy.fp32_high())
    assert y.dtype == torch.float32
    y.backward(t(g))
    _close(y, _mm_3pass_np(x, w.T) + b)
    _close(xt.grad, _mm_3pass_np(g, w))
    _close(wt.grad.t(), _mm_3pass_np(x.reshape(-1, 96).T, g.reshape(-1, 80)))
    _close(bt.grad, g.sum((0, 1)))
    # not the fp32 product: the 3-pass error shows at ~1e-6 relative
    exact = x.astype(np.float64) @ w.T.astype(np.float64) + b
    assert np.abs(y.detach().numpy() - exact).max() > 1e-7 * \
        np.abs(exact).max()
    assert np.abs(y.detach().numpy() - exact).max() < 3e-5 * \
        np.abs(exact).max()


def test_fp32_high_batched_matmul_and_its_gradients_are_3pass():
    """The batched 3-pass product (the text tower's attention scores and
    P·V, the batch-coupled V-V form, the stage-2 logits), forward and both
    gradients, per batch element against the emulation."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    b = rng.standard_normal((2, 3, 16, 9)).astype(np.float32)
    g = rng.standard_normal((2, 3, 7, 9)).astype(np.float32)
    at, bt = t(a).requires_grad_(), t(b).requires_grad_()
    y = L.matmul(at, bt, HIGH)
    y.backward(t(g))
    idx = np.ndindex(2, 3)
    for i in idx:
        _close(y[i], _mm_3pass_np(a[i], b[i]))
        _close(at.grad[i], _mm_3pass_np(g[i], b[i].T))
        _close(bt.grad[i], _mm_3pass_np(a[i].T, g[i]))
    # other precisions and bf16 operands keep matmul_f32
    torch.testing.assert_close(L.matmul(t(a), t(b), "highest"),
                               torch.matmul(t(a), t(b)), atol=0, rtol=0)
    a16, b16 = t(a).bfloat16(), t(b).bfloat16()
    torch.testing.assert_close(L.matmul(a16, b16, HIGH),
                               L.matmul_f32(a16, b16), atol=0, rtol=0)


# ------------------------------------------------- the attention kernels

# (heads, head dim, S, valid_len, JAX's q_blk)
ATTN_CASES = [(2, 64, 250, 250, 64), (2, 64, 250, 201, 64),
              (4, 16, 70, 70, 32), (4, 16, 70, 50, 32)]


@pytest.mark.parametrize("H,hd,S,valid,q_blk", ATTN_CASES)
def test_fp32_high_plain_b1_matches_pallas_interpret(H, hd, S, valid,
                                                     q_blk):
    qkv = packed_qkv(2, S, H, hd, seed=1)
    want = np.asarray(j_attention(jnp.asarray(qkv), H, valid, q_blk=q_blk,
                                  precision=HIGH, interpret=True))
    got = A.attention_packed_plain(t(qkv), H, valid, precision=HIGH)
    assert got.shape == (2, S, H * hd) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    fp32 = A.attention_packed_plain(t(qkv), H, valid).numpy()
    assert np.abs(got - want).max() < np.abs(got - fp32).max() / 2
    # on the CPU the wrapper is the plain version and launches nothing
    before = (A.attention_packed.launches, A.attention_packed.launches_3pass)
    torch.testing.assert_close(
        A.attention_packed(t(qkv), H, valid, precision=HIGH), t(got),
        atol=0, rtol=0)
    assert before == (A.attention_packed.launches,
                      A.attention_packed.launches_3pass)


@pytest.mark.parametrize("H,hd,S", [(2, 64, 250), (4, 16, 26)])
def test_fp32_high_plain_b3_matches_pallas_interpret(H, hd, S):
    v = np.random.default_rng(5).standard_normal(
        (2, S, H * hd)).astype(np.float32)
    want = np.asarray(j_attention(jnp.asarray(v), H, S, vv=True,
                                  packed_sections=1, q_blk=64 if S > 64
                                  else None, precision=HIGH,
                                  interpret=True))
    got = A.attention_packed_vv_plain(t(v), H, S, precision=HIGH).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        A.attention_packed_vv(t(v), H, S, precision=HIGH), t(got), atol=0,
        rtol=0)


@pytest.mark.parametrize("hd,valid", [(16, 50), (64, 70)])
def test_fp32_high_plain_b4_matches_pallas_interpret(hd, valid):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 70, hd)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(j_attention_kernel(
        *(jnp.asarray(x) for x in (q, k, v)), valid, q_blk=32, bh_blk=2,
        precision=HIGH, interpret=True))
    got = A.attention_kernel_plain(t(q), t(k), t(v), valid, precision=HIGH)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        A.attention_kernel(t(q), t(k), t(v), valid, precision=HIGH), got,
        atol=0, rtol=0)


@pytest.mark.parametrize("H,hd,S,valid,q_blk", ATTN_CASES)
def test_fp32_high_plain_b2_matches_pallas_interpret(H, hd, S, valid,
                                                     q_blk):
    qkv = packed_qkv(2, S, H, hd, seed=1)
    d_out = np.random.default_rng(4).standard_normal(
        (2, S, H * hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: j_diff(x, H, valid, q_blk, HIGH, True),
                     jnp.asarray(qkv))
    want = np.asarray(vjp(jnp.asarray(d_out))[0])
    got = A.attention_packed_bwd_plain(t(qkv), t(d_out), H, valid,
                                       precision=HIGH).numpy()
    dm = H * hd
    if valid < S:  # masked keys get no gradient
        assert not got[:, valid:, dm:].any()
    for i in range(3):  # dq, dk, dv
        sl = slice(i * dm, (i + 1) * dm)
        _close(got[..., sl], want[..., sl], 3e-5)
    # the differentiable form's CPU backward is the plain one
    x = t(qkv).requires_grad_()
    A.attention_packed_diff(x, H, valid, precision=HIGH).backward(t(d_out))
    torch.testing.assert_close(x.grad, t(got), atol=0, rtol=0)


def test_fp32_high_hook_passes_the_policy_precision():
    """``make_attn_fn`` hands its attention ``policy.precision``; bf16
    inputs ignore "high" (single-pass, as ``_kernel_precision``)."""
    seen = []

    def recording(x, heads, valid_len, precision=None):
        seen.append((x.dtype, precision))
        return A.attention_packed_plain(x, heads, valid_len,
                                        precision=precision)

    blk = L.ResidualBlock(64)
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x = torch.randn(2, 9, 64)
    for policy in (DtypePolicy.fp32_high(), DtypePolicy.fp32(),
                   DtypePolicy.fp32_high().prefix_policy()):
        A.make_attn_fn(4, policy, attention=recording)(x, blk.attn)
    assert seen == [(torch.float32, "high"), (torch.float32, "highest"),
                    (torch.bfloat16, None)]
    qkv = torch.randn(1, 9, 192).bfloat16()
    torch.testing.assert_close(
        A.attention_packed_plain(qkv, 4, 9, precision=HIGH),
        A.attention_packed_plain(qkv, 4, 9), atol=0, rtol=0)


# ------------------------------------------------------------- predict

def _predict_pair(bf16_until: int):
    jcfg, tcfg = jget_config("tiny-test"), get_config("tiny-test")
    visual, jad, vit, tad, jacfg, tacfg = both_models(jcfg, tcfg,
                                                      TINY_LEVELS, 0)
    jpol = dataclasses.replace(JPolicy.fp32_high(), bf16_until=bf16_until)
    tpol = dataclasses.replace(DtypePolicy.fp32_high(),
                               bf16_until=bf16_until)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 3, 70, 70)).astype(np.float32)
    a = rng.standard_normal((32, 2)).astype(np.float32)
    a /= np.linalg.norm(a, axis=0, keepdims=True)
    M = fused_postproc_matrix(5, 70, "Industrial")
    jp = j_make_predict_fn({"visual": visual}, jcfg, jacfg, policy=jpol,
                           attn_fn=j_make_attn_fn(4, jpol, interpret=True))
    jpix, jscore = jp(jad, jnp.asarray(x), jnp.asarray(a), jnp.asarray(M))
    tp = make_predict_fn(vit, tcfg, tacfg, policy=tpol, device="cpu")
    tpix, tscore = tp(tad, t(x), t(a), t(M))
    assert tpix.shape == (4, 70, 70) and tpix.dtype == torch.float32
    return np.asarray(jpix), np.asarray(jscore), tpix.numpy(), tscore.numpy()


def test_fp32_high_predict_unstaged_matches_jax():
    jpix, jscore, tpix, tscore = _predict_pair(0)
    span = jpix.max() - jpix.min()
    assert np.abs(tpix - jpix).max() <= 5e-5 * span
    np.testing.assert_allclose(tscore, jscore, atol=5e-6, rtol=0)


def test_fp32_high_predict_staged_matches_jax_at_the_bf16_bars():
    jpix, jscore, tpix, tscore = _predict_pair(1)
    assert np.corrcoef(tpix.ravel(), jpix.ravel())[0, 1] > 0.999
    np.testing.assert_allclose(tscore, jscore, atol=5e-3)


def test_fp32_high_predict_stages_the_prefix_blocks(monkeypatch):
    """The staged blocks run their adapters and attention under the bf16
    prefix policy, the rest under fp32_high; the stream stays fp32, the
    post-processing product is 3-pass."""
    from aaclip_tpu_torch.eval import predict as P
    from aaclip_tpu_torch.ops import similarity

    seen, pp = [], []
    real_block, real_pp = L.residual_block, similarity.apply_postproc_matrix

    def block(x, blk, heads, **kw):
        seen.append((x.dtype, kw["policy"].compute_dtype,
                     kw["policy"].precision))
        return real_block(x, blk, heads, **kw)

    monkeypatch.setattr(L, "residual_block", block)
    monkeypatch.setattr(P, "apply_postproc_matrix",
                        lambda q, M, p="highest": pp.append(p)
                        or real_pp(q, M, p))
    cfg = get_config("tiny-test")
    _, jad, vit, tad, _, tacfg = both_models(jget_config("tiny-test"), cfg,
                                             TINY_LEVELS, 0)
    policy = dataclasses.replace(DtypePolicy.fp32_high(), bf16_until=1)
    M = fused_postproc_matrix(5, 70, "Industrial")
    make_predict_fn(vit, cfg, tacfg, policy=policy, device="cpu")(
        tad, torch.zeros(1, 3, 70, 70), torch.ones(32, 2), t(M))
    assert seen == [(torch.float32, torch.bfloat16, None),
                    (torch.float32, torch.float32, "high")]
    assert pp == ["high"]


def test_fp32_high_staging_composes_with_remat():
    """The staged trunk under ``remat``: block 1 (3-pass) is checkpointed
    after the bf16-staged block 0 and its adapter blend; the forward and
    the adapters' gradients equal the unrematerialised run's bit for
    bit."""
    from aaclip_tpu_torch.models.vit import adapted_forward

    cfg = get_config("tiny-test")
    _, _, vit, tad, _, tacfg = both_models(jget_config("tiny-test"), cfg,
                                           TINY_LEVELS, 0)
    policy = dataclasses.replace(DtypePolicy.fp32_high(), bf16_until=1)
    x = t(np.random.default_rng(4).standard_normal((2, 3, 70, 70))
          .astype(np.float32))
    runs = []
    for remat in (False, True):
        tad.zero_grad(set_to_none=True)
        seg, det = adapted_forward(vit, tad, cfg, x, levels=tacfg.levels,
                                   policy=policy, remat=remat)
        (sum(s.sum() for s in seg) + det.square().sum()).backward()
        runs.append([det.detach()] + [p.grad.clone()
                                      for p in tad.parameters()])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ----------------------------------------------------------- the steps

def test_fp32_high_stage2_step_matches_jax_over_five_steps():
    case = step_case()
    jpol = JPolicy.fp32_high()
    attn = j_make_attn_fn(4, jpol, differentiable=True, interpret=True)
    run = jax_step(case, jpol, joptim.make_image_optimizer(
        1e-3, milestones=(2, 4)), attn_fn=attn)
    ad, step = port_step(case, DtypePolicy.fp32_high())
    left_out = []
    for i in range(5):
        want_loss, state = run()
        np.testing.assert_allclose(float(step()), want_loss, rtol=1e-5)
        if i == 0:
            first_grad = grads_as_jax(ad)
        if i in (0, 4):
            left_out.append(assert_adapter_close(ad, state.params,
                                                 first_grad))
    n = sum(x.size for x in jax.tree.leaves(first_grad))
    assert left_out[0] == left_out[1] <= 0.001 * n, (left_out, n)


def test_fp32_high_stage2_gradients_match_jax():
    case = step_case()
    jpol = JPolicy.fp32_high()
    run = jax_step(case, jpol, grad_capture(),
                   attn_fn=j_make_attn_fn(4, jpol, differentiable=True,
                                          interpret=True))
    want_loss, state = run()
    ad, step = port_step(case, DtypePolicy.fp32_high())
    np.testing.assert_allclose(float(step()), want_loss, rtol=1e-5)
    for g, w in zip(jax.tree.leaves(grads_as_jax(ad)),
                    jax.tree.leaves(state.opt_state)):
        _close(g, np.asarray(w), 1e-4)


@pytest.fixture(scope="module")
def s1case():
    return Stage1Case()


@pytest.mark.parametrize("vv_mode", ["batch", "spatial"])
def test_fp32_high_stage1_features_match_jax(s1case, vv_mode):
    jpol = JPolicy.fp32_high()
    kw = {}
    if vv_mode == "spatial":
        kw["vv_attn_fn"] = j_make_attn_fn(4, jpol, vv=True, interpret=True)
    want = np.asarray(j_features_fn(
        s1case.clip, s1case.jcfg, surgery_until_layer=2, policy=jpol,
        vv_mode=vv_mode, attn_fn=j_make_attn_fn(4, jpol, interpret=True),
        **kw)(jnp.asarray(s1case.images)))
    got = stage1_features_fn(s1case.vit, s1case.cfg, surgery_until_layer=2,
                             policy=DtypePolicy.fp32_high(), vv_mode=vv_mode,
                             device="cpu")(t(s1case.images))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


def test_fp32_high_stage1_step_matches_jax_over_five_steps(s1case):
    jpol = JPolicy.fp32_high()
    feats = s1case.jax_feats
    jstep, state = jax_stage1(s1case, jpol, joptim.make_text_optimizer(1e-3))
    ad, step = port_stage1(s1case, DtypePolicy.fp32_high())
    jb = [jnp.asarray(x) for x in (feats, s1case.mask, s1case.cidx,
                                   s1case.valid)]
    for i in range(5):
        state, want_loss = jstep(state, *jb)
        got_loss = step(ad, *batch(s1case, t(feats)))
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=5e-5)
        if i in (0, 4):
            for g, w in zip(jax.tree.leaves(text_adapter_to_jax(ad)),
                            jax.tree.leaves(state.params)):
                np.testing.assert_allclose(g, np.asarray(w), atol=4e-5,
                                           rtol=0)


def test_fp32_high_stage1_gradients_match_jax(s1case):
    feats = s1case.jax_feats
    jstep, state = jax_stage1(s1case, JPolicy.fp32_high(), grad_capture())
    cells = dict(zip(jstep.__code__.co_freevars, jstep.__closure__))
    state, want_loss = cells["_step"].cell_contents(
        state, cells["text_params"].cell_contents,
        *[jnp.asarray(x) for x in (feats, s1case.mask, s1case.cidx,
                                   s1case.valid)])
    ad, step = port_stage1(s1case, DtypePolicy.fp32_high())
    got_loss = float(step(ad, *batch(s1case, t(feats))))
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=5e-5)
    grads = [lin.weight.grad.numpy().T for lin in (*ad.layer_adapters,
                                                   ad.proj)]
    wants = [np.asarray(state.opt_state["layer_adapters"]["w"][0]),
             np.asarray(state.opt_state["proj"]["w"])]
    for g, w in zip(grads, wants):
        _close(g, w, 6e-5)


# ------------------------------------------------------- the fused block

def test_fp32_high_fused_block_raises_naming_b8(monkeypatch):
    """B5-B7's 3-pass mode (ROADMAP B8) is ported: ``make_block_fn`` under
    "high" builds a block whose wrappers take the 3-pass route on fp32
    operands (their CPU tensors run the 3-pass plain versions, which count
    no launch), and the gate still gives None under fp32_high even on the
    card, as JAX's gate admits bf16 alone."""
    high = DtypePolicy.fp32_high()
    block = FB.make_block_fn(4, high, act=L.gelu)
    assert callable(block)
    assert FB.route(torch.float32, high.precision) == FB.HIGH
    assert FB.HIGH in FB.TMA_ROUTES
    assert FB.fused_block_supported(get_config("ViT-L-14-336"), high)
    blk = L.ResidualBlock(256, 4.0).requires_grad_(False)
    x = torch.randn(1, 5, 256)
    before = (FB.ln_linear.launches, FB.mlp_fused.launches_3pass)
    out = block(x, blk)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert before == (FB.ln_linear.launches, FB.mlp_fused.launches_3pass)
    # its bf16 prefix policy and the other policies still build
    FB.make_block_fn(4, high.prefix_policy(), act=L.gelu)
    FB.make_block_fn(4, DtypePolicy.fp32(), act=L.gelu)
    vit_l = get_config("ViT-L-14-336")
    assert FB.maybe_make_block_fn(vit_l, DtypePolicy.fp32_high(),
                                  device="cpu") is None
    monkeypatch.setattr(FB, "resolve_device",
                        lambda device: torch.device("cuda"))
    assert FB.maybe_make_block_fn(vit_l, DtypePolicy.fp32_high()) is None
    assert callable(FB.maybe_make_block_fn(
        vit_l, DtypePolicy.fp32_high().prefix_policy()))


# ------------------------------------------------- the kernels' sources

@pytest.mark.parametrize("source,entry,loader,n_params", [
    ("attention_packed", "aaclip_attention_packed_3pass", "fwd", 15),
    ("attention_packed", "aaclip_attention_bhsd_3pass", "bhsd", 11),
    ("attention_packed_bwd", "aaclip_attention_packed_bwd_3pass", "bwd", 17),
])
def test_fp32_high_entry_points_match_the_c_signatures(source, entry,
                                                       loader, n_params):
    """``_kernels_3pass`` declares one ctypes argument per parameter of
    each 3-pass C entry point, and each entry takes head dim 16 in fp32 on
    its mma.sync kernels; ``KERNEL_HEAD_DIMS``' others, 64 (and 80, 88,
    104 and 128 in the forward), have an entry of their own
    (``<entry>_wgmma``, TMA + wgmma on the split planes)."""
    import inspect
    import re

    from aaclip_tpu_torch.kernels import build

    src = (build.CSRC / f"{source}.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    assert "bf16" not in sig and sig.count("float*") >= 2
    code = inspect.getsource(A._kernels_3pass)
    argtypes = re.search(rf"{loader}\.argtypes = \[([^\]]*)\]",
                         code).group(1)
    assert len(argtypes.split(",")) == len(sig.split(",")) == n_params
    assert A.KERNEL_HEAD_DIMS == (16, 64, 80, 88, 104, 128)
    assert "<16><<<" in src and "<64><<<" not in src
    assert f'extern "C" int {entry}_wgmma(' in src


def test_fp32_high_mode_is_fp32_under_high_only():
    assert A._three_pass(torch.float32, "high")
    for dtype, prec in ((torch.float32, "highest"), (torch.float32, None),
                        (torch.bfloat16, "high"), (torch.bfloat16, None)):
        assert not A._three_pass(dtype, prec)
    for wrapper in (A.attention_packed, A.attention_packed_vv,
                    A.attention_kernel, A.attention_packed_bwd):
        assert wrapper.launches_3pass <= wrapper.launches

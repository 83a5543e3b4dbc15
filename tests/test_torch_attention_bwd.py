"""The port's attention backward (aaclip_tpu_torch/ops/attention.py)
against the JAX package's, on the CPU, where the wrappers run their plain
versions:

* ``attention_packed_bwd_plain`` vs ``jax.vjp`` of the Pallas
  ``attention_packed_diff`` in interpret mode (2 images, 2 heads x 64,
  S 250, q_blk 64, valid_len 250 and 201, fp32 and bf16);
* the same at head dims 80, 88, 104 and 128 (2 heads: JAX's gate runs
  its Pallas backward at 128, and interpret mode tiles the others) against
  JAX's ``_attention_packed_bwd_impl(..., interpret=True)`` itself, fp32
  and bf16, at the same bars; and at 80, 88 and 104 in fp32 against
  ``jax.vjp`` of ``models/layers.py::attention``, the XLA path JAX's gate
  sends those head dims to (a unit out-projection, keys past valid_len
  masked), through the input projection: atol 1e-5 of the gradient's max,
  the fp32 bar with the projections' sums in another order;
* the schedule of the bf16 backward at head dims 88 and 104 on the card
  (``_key_outer_schedule``, test code: dsum first, then per 128-key block
  dS, dV, dK and a dQ partial, dQ summed over the blocks in their order in
  fp32 and cast at the end), at fp32 and in bf16 roundings, against
  ``attention_packed_bwd_plain`` and JAX's ``_attention_packed_bwd_impl``
  in interpret mode, at ragged S and valid_len < S (a key block wholly
  past valid_len included), at the bars below;
* which (dtype, head dim) takes that plan: the wrapper's route to the
  bf16 entry point and the source's ``key_outer_head_dim``, which both its
  dispatch and its workspace query (``_bwd_workspace_tiles``) read;
* the autograd Function's CPU backward is the plain backward, exactly;
* the differentiable ``attn_fn`` hook's gradients vs ``jax.vjp`` of the
  JAX hook at tiny-test's head dim 16;
* the wrappers' routing and refusals.

The CUDA kernel itself is checked against the plain version on the card
by chip_smoke.py.

fp32 bar (``precision="highest"`` on the JAX side): atol 1e-5, rtol 1e-5,
the same arithmetic in another summation order. bf16 bar: both round dO,
P (for dV), dS and the outputs to bf16 at the same points, so they agree
to one bf16 ulp of each gradient's max (2^-8 relative).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.models.layers import attention as j_xla_attention
from aaclip_tpu.ops.flash_attention import \
    _attention_packed_bwd_impl as j_bwd_impl
from aaclip_tpu.ops.flash_attention import attention_packed_diff as j_diff
from aaclip_tpu.ops.flash_attention import make_attn_fn as j_make_attn_fn
from aaclip_tpu_torch.core.config import DtypePolicy, get_config
from aaclip_tpu_torch.core.params import params_from_jax
from aaclip_tpu_torch.kernels import build
from aaclip_tpu_torch.ops import attention as A
from aaclip_tpu_torch.ops.attention import (attention_packed,
                                            attention_packed_bwd,
                                            attention_packed_bwd_plain,
                                            attention_packed_diff,
                                            attention_packed_diff_plain,
                                            attention_packed_vv,
                                            make_attn_fn)
from tests.test_torch_attention import DTYPES, packed_qkv
from tests.test_torch_layers import perturbed_clip_tree


def jax_vjp(qkv, d_out, heads, valid_len, jd, precision):
    _, vjp = jax.vjp(
        lambda x: j_diff(x, heads, valid_len, 64, precision, True),
        jnp.asarray(qkv, jd))
    return np.asarray(vjp(jnp.asarray(d_out, jd))[0], np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("valid_len", [250, 201])
def test_plain_bwd_matches_pallas_interpret(dtype, valid_len):
    jd, td = DTYPES[dtype]
    qkv = packed_qkv(2, 250, 2, 64, seed=3)
    d_out = np.random.default_rng(4).standard_normal(
        (2, 250, 128)).astype(np.float32)
    want = jax_vjp(qkv, d_out, 2, valid_len, jd,
                   "highest" if dtype == "fp32" else None)
    got = attention_packed_bwd_plain(torch.from_numpy(qkv).to(td),
                                     torch.from_numpy(d_out).to(td), 2,
                                     valid_len)
    assert got.shape == (2, 250, 384) and got.dtype == td
    got = got.float().numpy()
    if valid_len < 250:  # masked keys get no gradient, on both sides
        assert not got[:, valid_len:, 128:].any()
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        for i in range(3):  # dq, dk, dv
            sl = slice(i * 128, (i + 1) * 128)
            ulp = 2 ** -8 * np.abs(want[..., sl]).max()
            np.testing.assert_allclose(got[..., sl], want[..., sl], atol=ulp,
                                       rtol=0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("valid_len", [250, 201])
@pytest.mark.parametrize("head_dim", [80, 88, 104, 128])
def test_plain_bwd_matches_pallas_interpret_at_wide_head_dims(
        head_dim, valid_len, dtype):
    """Head dims 80, 88, 104 and 128 in 2 heads, ragged S 250 (q_blk 64),
    valid_len 250 and 201: the plain backward against JAX's backward kernel
    in interpret mode, at the hd-64 test's bars."""
    jd, td = DTYPES[dtype]
    dm = 2 * head_dim
    qkv = packed_qkv(2, 250, 2, head_dim, seed=23)
    d_out = np.random.default_rng(24).standard_normal(
        (2, 250, dm)).astype(np.float32)
    want = np.asarray(j_bwd_impl(
        jnp.asarray(qkv, jd), jnp.asarray(d_out, jd), 2, valid_len, 64,
        "highest" if dtype == "fp32" else None, True), np.float32)
    got = attention_packed_bwd_plain(torch.from_numpy(qkv).to(td),
                                     torch.from_numpy(d_out).to(td), 2,
                                     valid_len)
    assert got.shape == (2, 250, 3 * dm) and got.dtype == td
    got = got.float().numpy()
    if valid_len < 250:
        assert not got[:, valid_len:, dm:].any()
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        for i in range(3):
            sl = slice(i * dm, (i + 1) * dm)
            ulp = 2 ** -8 * np.abs(want[..., sl]).max()
            np.testing.assert_allclose(got[..., sl], want[..., sl], atol=ulp,
                                       rtol=0)


def _key_outer_schedule(qkv, d_out, heads, valid_len, block=128):
    """d(qkv) as the card's bf16 backward at head dims 88 and 104 orders it
    (test code, not the port's): dsum = rowsum(dP * P) over all keys
    first (P = exp(s - lse), fp32), then per key block of ``block`` keys
    below valid_len dS = P * (dP - dsum) * scale rounded to the input
    dtype, dV = round(P)^T dO, dK = dS^T Q and the block's dQ partial dS K,
    each in fp32; dQ is the partials summed in fp32 in the blocks' order,
    cast at the end, and key blocks wholly past valid_len get zero dK and
    dV. In fp32 the roundings are no-ops."""
    B, S, three_dm = qkv.shape
    dm = three_dm // 3
    hd = dm // heads
    dt = qkv.dtype
    scale = hd ** -0.5

    def split(t):
        return t.reshape(B, S, heads, hd).transpose(1, 2).float()

    q, k, v = (split(qkv[..., i * dm:(i + 1) * dm]) for i in range(3))
    do = split(d_out.to(dt))
    s = q @ k.transpose(-1, -2) * scale
    s[..., valid_len:] = float("-inf")
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    dp = do @ v.transpose(-1, -2)
    dsum = (dp * p).sum(-1, keepdim=True)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, valid_len, block):
        keys = slice(k0, min(k0 + block, S))
        pb = p[..., keys]
        ds = (pb * (dp[..., keys] - dsum) * scale).to(dt).float()
        dv[..., keys, :] = pb.to(dt).float().transpose(-1, -2) @ do
        dk[..., keys, :] = ds.transpose(-1, -2) @ q
        dq = dq + ds @ k[..., keys, :]
    return torch.cat([g.to(dt).transpose(1, 2).reshape(B, S, dm)
                      for g in (dq, dk, dv)], dim=-1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S,valid_len", [(77, 77), (200, 200), (200, 150),
                                         (200, 100)])
@pytest.mark.parametrize("head_dim", [88, 104])
def test_key_outer_schedule_matches_plain_and_pallas_interpret(
        head_dim, S, valid_len, dtype):
    """The card's bf16 plan at 88 and 104 (dsum pre-pass, then 128-key
    blocks each adding its dQ partial in order) computes the reference's
    function: against ``attention_packed_bwd_plain`` and JAX's backward
    kernel in interpret mode (q_blk 64), 2 heads, ragged S 77 (one partial
    block) and 200, valid_len 200, 150 (the second block partly masked) and
    100 (the second block wholly past valid_len: zero dK and dV, no
    partial). Bars: fp32 atol 1e-5, rtol 1e-5 (the same arithmetic, dQ
    summed over blocks in another order); bf16 one bf16 ulp of each
    gradient's max (2^-8 relative), as the plain backward is held to
    JAX's: both round P, dS and the outputs at the same points, and the
    fp32 sums before the last rounding differ only in their order."""
    jd, td = DTYPES[dtype]
    dm = 2 * head_dim
    qkv = packed_qkv(2, S, 2, head_dim, seed=31)
    d_out = np.random.default_rng(32).standard_normal(
        (2, S, dm)).astype(np.float32)
    x, g = torch.from_numpy(qkv).to(td), torch.from_numpy(d_out).to(td)
    got = _key_outer_schedule(x, g, 2, valid_len)
    assert got.shape == (2, S, 3 * dm) and got.dtype == td
    plain = attention_packed_bwd_plain(x, g, 2, valid_len).float().numpy()
    want = np.asarray(j_bwd_impl(
        jnp.asarray(qkv, jd), jnp.asarray(d_out, jd), 2, valid_len, 64,
        "highest" if dtype == "fp32" else None, True), np.float32)
    got = got.float().numpy()
    if valid_len < S:  # keys past valid_len get no dK or dV
        assert not got[:, valid_len:, dm:].any()
    for ref in (plain, want):
        if dtype == "fp32":
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
            continue
        for i in range(3):
            sl = slice(i * dm, (i + 1) * dm)
            ulp = 2 ** -8 * np.abs(ref[..., sl]).max()
            np.testing.assert_allclose(got[..., sl], ref[..., sl], atol=ulp,
                                       rtol=0)


def _source_key_outer_head_dims() -> tuple:
    """The head dims of ``key_outer_head_dim`` in attention_packed_bwd.cu."""
    bwd = (build.CSRC / "attention_packed_bwd.cu").read_text()
    body = re.search(r"constexpr bool key_outer_head_dim\(int hd\) "
                     r"\{([^}]*)\}", bwd).group(1)
    return tuple(int(d) for d in re.findall(r"hd == (\d+)", body))


@pytest.mark.parametrize("head_dim", A.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype,precision", [
    (torch.bfloat16, None), (torch.bfloat16, "high"),
    (torch.float32, None), (torch.float32, "highest"),
    (torch.float32, "high")])
def test_key_outer_plan_is_bf16_at_88_and_104(dtype, precision, head_dim):
    """bf16 at 88 and 104 takes the dsum pre-pass and the key-outer kernel
    (whatever the precision: bf16 ignores it); every other (dtype, head
    dim) keeps its route's pair. The wrapper hands bf16 on the "wgmma"
    route to the bf16 entry point with ``bf16`` 1 (the fp32 routes have
    entries of their own, which take no workspace), and the source sends
    ``key_outer_head_dim`` there to the key-outer plan."""
    want = dtype == torch.bfloat16 and head_dim in (88, 104)
    route = A.kernel_route(dtype, head_dim, precision)
    got = route == "wgmma" and head_dim in _source_key_outer_head_dims()
    assert got is want


def test_workspace_query_and_dispatch_share_key_outer_head_dim():
    """One predicate picks the plan: the entry point dispatches
    ``key_outer_head_dim`` to ``launch_key_outer`` (the pre-pass and the
    key-outer kernel) and nothing else to it, and the workspace query
    answers 0 unless bf16 at ``key_outer_head_dim``; the pre-pass zeroes
    the counters, so the wrapper allocates them uninitialised."""
    assert _source_key_outer_head_dims() == (88, 104)
    bwd = (build.CSRC / "attention_packed_bwd.cu").read_text()
    assert "if constexpr (key_outer_head_dim(HD))" in bwd
    assert bwd.count("launch_key_outer<HD>(") == 1
    for name in ("attn_bwd_dsum_wgmma", "attn_bwd_kv_wgmma"):
        assert f"{name}<HD><<<" in bwd
    query = bwd[bwd.index('int aaclip_attention_packed_bwd_workspace('):]
    query = query[:query.index("\n}\n")]
    assert "if (!bf16 || !key_outer_head_dim(head_dim)) return 0;" in query
    dsum = bwd[bwd.index("attn_bwd_dsum_wgmma(const"):]
    assert "] = 0;" in dsum[:dsum.index("query_outer<HD, false>")]


def test_bwd_workspace_is_one_tile_row_per_query_tile():
    """The key-outer kernel's workspace for the query tiles the source
    asks for: dQ's fp32 sums over every 64-row query tile of each (image,
    head), and one int32 counter per (image, head, query tile) plus the
    ticket."""
    acc, counters = A._bwd_workspace(3, 2, 3, 88, "cpu")
    assert acc.shape == (2, 3, 192, 88) and acc.dtype == torch.float32
    assert counters.shape == (2 * 3 * 3 + 1,)
    assert counters.dtype == torch.int32
    acc, counters = A._bwd_workspace(22, 8, 16, 104, "cpu")
    assert acc.shape == (8, 16, 1408, 104) and counters.numel() == 2817


@pytest.mark.parametrize("valid_len", [250, 201])
@pytest.mark.parametrize("head_dim", [80, 88, 104])
def test_plain_bwd_matches_the_xla_path_at_wide_head_dims(head_dim,
                                                          valid_len):
    """fp32, 2 heads of 80, 88 or 104 (JAX's gate sends all three to
    XLA), S 250: ``jax.vjp`` of JAX's XLA attention (``layers.attention``
    with a unit out-projection and keys past valid_len masked) w.r.t. its
    input, against the port's plain backward of the same packed projection
    carried back through it."""
    B, S, H, hd = 2, 250, 2, head_dim
    dm = H * hd
    rng = np.random.default_rng(25)
    x = rng.standard_normal((B, S, dm)).astype(np.float32)
    w = (rng.standard_normal((dm, 3 * dm)) * dm ** -0.5).astype(np.float32)
    b = rng.standard_normal(3 * dm).astype(np.float32)
    g = rng.standard_normal((B, S, dm)).astype(np.float32)
    p = {"w_qkv": jnp.asarray(w), "b_qkv": jnp.asarray(b),
         "w_out": jnp.eye(dm, dtype=jnp.float32),
         "b_out": jnp.zeros(dm, jnp.float32)}
    mask = jnp.where(jnp.arange(S) < valid_len, 0.0, -jnp.inf)
    _, vjp = jax.vjp(lambda v: j_xla_attention(v, p, H, mask=mask,
                                               policy=JPolicy.fp32()),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0], np.float32)
    qkv = torch.from_numpy(x) @ torch.from_numpy(w) + torch.from_numpy(b)
    d_qkv = attention_packed_bwd_plain(qkv, torch.from_numpy(g), H,
                                       valid_len)
    got = (d_qkv @ torch.from_numpy(w).T).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_function_cpu_backward_is_the_plain_backward(dtype):
    td = DTYPES[dtype][1]
    qkv = torch.from_numpy(packed_qkv(2, 37, 2, 16, seed=5)).to(td)
    d_out = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 37, 32)).astype(np.float32)).to(td)
    want = attention_packed_bwd_plain(qkv, d_out, 2, 30)
    before = (attention_packed.launches, attention_packed_bwd.launches)
    for fn in (attention_packed_diff, attention_packed_diff_plain):
        x = qkv.clone().requires_grad_()
        out = fn(x, 2, 30)
        torch.testing.assert_close(
            out, attention_packed(qkv, 2, 30), atol=0, rtol=0)
        out.backward(d_out)
        torch.testing.assert_close(x.grad, want, atol=0, rtol=0)
    assert torch.equal(attention_packed_bwd(qkv, d_out, None, 2, 30), want)
    assert (attention_packed.launches,
            attention_packed_bwd.launches) == before


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_differentiable_attn_fn_matches_jax(policy):
    """tiny-test block 0 (4 heads x 16): the differentiable hook's
    gradients (input and in-projection weight) against jax.vjp of the JAX
    hook with the Pallas custom VJP in interpret mode."""
    cfg = get_config("tiny-test")
    jpol, tpol = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
                  "bf16": (JPolicy.bf16(), DtypePolicy.bf16())}[policy]
    visual = perturbed_clip_tree("tiny-test", seed=7)
    vit = params_from_jax(visual, cfg, device="cpu")
    jp = {k: jnp.asarray(v[0]) for k, v in visual["blocks"]["attn"].items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 26, 64)).astype(np.float32)
    g = rng.standard_normal((2, 26, 64)).astype(np.float32)
    j_fn = j_make_attn_fn(4, jpol, differentiable=True, interpret=True)
    _, vjp = jax.vjp(lambda x, w: j_fn(x, {**jp, "w_qkv": w}),
                     jnp.asarray(x), jp["w_qkv"])
    jdx, jdw = (np.asarray(t, np.float32) for t in vjp(jnp.asarray(g)))

    attn = vit.blocks[0].attn
    attn.in_proj_weight.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    make_attn_fn(4, tpol, differentiable=True)(xt, attn).backward(
        torch.from_numpy(g))
    tdx, tdw = xt.grad.numpy(), attn.in_proj_weight.grad.numpy().T
    if policy == "fp32":
        np.testing.assert_allclose(tdx, jdx, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tdw, jdw, atol=1e-5, rtol=1e-5)
    else:
        # bf16 operands rounded at the same points on both sides: a few
        # ulps of each gradient's max after two rounded products
        for got, want in ((tdx, jdx), (tdw, jdw)):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2 ** -6 * np.abs(want).max())


def test_vv_has_no_differentiable_variant():
    with pytest.raises(ValueError, match="no differentiable variant"):
        make_attn_fn(4, vv=True, differentiable=True)
    # the forward-only V-V hook exists: it routes to the V-V kernel wrapper
    # (through the aaclip::attention_packed operator)
    fn = make_attn_fn(4, vv=True)
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    assert cells["attention"].cell_contents.wrapper is attention_packed_vv


def test_hook_picks_the_differentiable_wrapper():
    """The hook's attention is the differentiable kernel path for
    training and the forward-only wrapper otherwise (through the
    aaclip::attention_packed operator); an explicit ``attention`` wins."""
    def closure_attention(fn):
        cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
        return cells["attention"].cell_contents

    assert closure_attention(make_attn_fn(4)).wrapper is attention_packed
    assert closure_attention(
        make_attn_fn(4, differentiable=True)) is attention_packed_diff
    assert closure_attention(make_attn_fn(
        4, differentiable=True,
        attention=attention_packed_diff_plain)) is attention_packed_diff_plain


def test_bwd_wrapper_refuses_other_devices_and_bad_lse():
    with pytest.raises(ValueError, match="unsupported device"):
        attention_packed_bwd(torch.empty(1, 8, 48, device="meta"),
                             torch.empty(1, 8, 16, device="meta"), None, 1, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        attention_packed(torch.zeros(1, 8, 48), 1, 8, return_lse=True)


def test_bwd_entry_point_matches_the_c_signature():
    """The ctypes argument list has one entry per parameter of the C
    entry point in attention_packed_bwd.cu."""
    src = (build.CSRC / "attention_packed_bwd.cu").read_text()
    sig = re.search(r'extern "C" int aaclip_attention_packed_bwd\(([^)]*)\)',
                    src).group(1)
    code = (build.CSRC.parent.parent / "ops" / "attention.py").read_text()
    bwd = code[code.index("def _bwd_kernel"):]
    argtypes = re.search(r"fn\.argtypes = \[([^\]]*)\]", bwd).group(1)
    assert len(argtypes.split(",")) == len(sig.split(",")) == 20
    # the key-outer kernel's workspace, between d_qkv and bf16
    assert "void* d_qkv, float* dq_acc, int* counters, int bf16," in sig
    # its size: (bf16, head_dim, seq) -> query tiles, three ints
    query = re.search(r'extern "C" int aaclip_attention_packed_bwd_workspace'
                      r'\(([^)]*)\)', src).group(1)
    assert [a.split()[0] for a in query.split(",")] == ["int"] * 3
    tiles = code[code.index("def _bwd_workspace_tiles"):]
    assert "fn.argtypes = [ctypes.c_int] * 3" in tiles


def test_every_kernel_source_is_built():
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}
    p = build.library_path("attention_packed_bwd")
    assert p.name.startswith("libattention_packed_bwd-")
    assert p != build.library_path("attention_packed")

"""The 3-pass route of the port's fp32 attention at head dim 64 (precision
"high", fp32_high's attention) on the CPU, where the wrappers run their
plain versions:

* ``split2_plain`` is ``models/layers.py::_split_bf16``'s hi and lo, and
  planes 0 and 1 of ``split3_plain``, bit for bit, on seeded random fp32
  values, powers of two, values near the largest and the smallest
  normals, negative zero and NaN;
* the kernels' arithmetic (two planes, the three products hi·lo, lo·hi,
  hi·hi summed in fp32 in that order, P and dS split rather than rounded,
  keys in tiles of 64 at head dim 64 and of 32 at 80 and 128, each tile's
  product in its own accumulator) through the forward and the backward at
  head dims 64, 80 and 128, against the JAX package's Pallas
  kernels in interpret mode at "high", the only 3-pass reference on the
  CPU (jax on the CPU computes XLA "high" dots in true fp32): the plain
  versions' bars, atol and rtol 1e-5 forward and 5e-5 of each gradient's
  max backward;
* the route table (``kernel_route``) for every (dtype, head dim,
  precision), the launch counters by route, the new C entry points'
  signatures, and the removal of the mma.sync 3-pass kernels at head
  dim 64.

The CUDA kernels themselves (``split2_kernel``, ``attn_fwd_3pass_wgmma``,
``attn_bwd_{dq,dkdv}_3pass_wgmma``) run only on the card: ``chip_smoke.py``
holds them against ``split2_plain`` bit for bit and against the plain
3-pass versions.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.ops.flash_attention import attention_packed as j_attention
from aaclip_tpu.ops.flash_attention import attention_packed_diff as j_diff
from aaclip_tpu_torch.kernels import build
from aaclip_tpu_torch.models.layers import _split_bf16
from aaclip_tpu_torch.ops import attention as A
from tests.test_torch_attention import packed_qkv
from tests.test_torch_attention_fp32 import _special

TILE = 64  # keys (forward, kernel A) and queries (kernel B) per tile


def fwd_tile(head_dim: int) -> int:
    """The forward plane kernels' keys per tile (``PlaneTiles::kKeys``):
    64 at head dim 64, 32 at 80 and 128."""
    return TILE if head_dim == 64 else 32


def bwd_tile(head_dim: int) -> int:
    """The backward plane pairs' rows per streamed tile
    (``BwdTiles::kWalk``): keys of kernel A, queries of kernel B; 64 at
    head dim 64, 32 at 80 and 128."""
    return TILE if head_dim == 64 else 32


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


@pytest.mark.parametrize("kind", ["random", "powers_of_two", "near_largest",
                                  "near_smallest_normal"])
def test_split2_is_split_bf16_and_split3s_first_planes(kind):
    x = torch.from_numpy(_special(kind))
    planes = A.split2_plain(x)
    assert planes.shape == (2, *x.shape) and planes.dtype == torch.bfloat16
    hi, lo = _split_bf16(x)
    assert torch.equal(_bits(planes[0]), _bits(hi))
    assert torch.equal(_bits(planes[1]), _bits(lo))
    assert torch.equal(_bits(planes), _bits(A.split3_plain(x)[:2]))


def test_split2_negative_zero_and_nan():
    x = torch.tensor([-0.0, 0.0, float("nan"), -float("nan"), 1.5])
    planes = A.split2_plain(x)
    assert torch.equal(_bits(planes), _bits(A.split3_plain(x)[:2]))
    hi, lo = planes.float()
    assert torch.signbit(hi[0]) and not torch.signbit(hi[1])
    assert float(lo[0]) == float(lo[1]) == 0.0
    assert bool(torch.isnan(planes[:, 2:4].float()).all())
    assert float(hi[4]) == 1.5 and float(lo[4]) == 0.0


@pytest.mark.parametrize("shape", [(2, 37, 384), (5,), (3, 1, 7)])
def test_split2_takes_the_plain_version_on_the_cpu(shape):
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(shape)
                         .astype(np.float32))
    before = A.split2.launches
    assert torch.equal(A.split2(x), A.split2_plain(x))
    assert A.split2.launches == before
    with pytest.raises(ValueError, match="split2: need an fp32 CUDA"):
        A.split2(torch.empty(4, device="meta"))


def _kdot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of fp32 tensors as the 3-pass kernels compute it: the
    bf16 products of ``split2_plain``'s planes (each exact in fp32) summed
    in fp32 in the kernels' order, smallest first: hi·lo, lo·hi, hi·hi."""
    ah, al = A.split2_plain(a).float()
    bh, bl = A.split2_plain(b).float()
    out = torch.matmul(ah, bl)
    out = out + torch.matmul(al, bh)
    return out + torch.matmul(ah, bh)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    B, S, dm = t.shape
    return t.reshape(B, S, heads, dm // heads).transpose(1, 2)


def _forward3(q, k, v, valid: int, scale: float):
    """The 3-pass forward kernel's arithmetic on [B, H, S, hd]: keys in
    tiles of ``fwd_tile(hd)``, the online softmax (P = exp(s - running
    max) in fp32, split, never rounded), each tile's P·V in its own
    accumulator added to the running O (O = O·alpha + tile), one division
    at the end; returns (out, lse = m + log l)."""
    B, H, S, hd = q.shape
    tile = fwd_tile(hd)
    o = torch.zeros(B, H, S, hd)
    m = torch.full((B, H, S, 1), float("-inf"))
    l = torch.zeros(B, H, S, 1)
    for k0 in range(0, valid, tile):
        k1 = min(k0 + tile, S)
        s = _kdot3(q, k[..., k0:k1, :].transpose(-1, -2)) * scale
        s[..., max(valid - k0, 0):] = float("-inf")
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        mref = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp(m - mref)
        p = torch.exp(s - mref)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _kdot3(p, v[..., k0:k1, :])
        m = m_new
    return o / l, m + torch.log(l)


def _backward3(q, k, v, do, lse, valid: int, scale: float):
    """The 3-pass backward pair's arithmetic on [B, H, S, hd]: kernel A
    (query-outer) takes P = exp(s - lse) and dP, dsum = rowsum(dP·P),
    dS = P·(dP - dsum)·scale in fp32 (split, never rounded) and sums
    dQ = dS·K over tiles of ``bwd_tile(hd)`` keys, each tile's product in
    its own accumulator; kernel B (key-outer) sums dV = Pᵀ·dO and
    dK = dSᵀ·Q over tiles of as many queries the same way."""
    S, hd = q.shape[-2:]
    tile = bwd_tile(hd)
    s = _kdot3(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse)
    p[..., valid:] = 0.0
    dp = _kdot3(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = sum(_kdot3(ds[..., k0:k0 + tile], k[..., k0:k0 + tile, :])
             for k0 in range(0, valid, tile))
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    dv = sum(_kdot3(pt[..., q0:q0 + tile], do[..., q0:q0 + tile, :])
             for q0 in range(0, S, tile))
    dk = sum(_kdot3(dst[..., q0:q0 + tile], q[..., q0:q0 + tile, :])
             for q0 in range(0, S, tile))
    return dq, dk, dv


def _attention3(qkv: torch.Tensor, heads: int, valid: int,
                d_out: torch.Tensor | None = None) -> torch.Tensor:
    """The 3-pass kernels on a packed fp32 qkv: the forward [B, S, D], or
    with ``d_out`` d(qkv) [B, S, 3D] from the forward's lse."""
    B, S, dm, hd, scale, offs = A._split(qkv, heads)
    q, k, v = (_heads(qkv[..., o:o + dm], heads) for o in offs)
    out, lse = _forward3(q, k, v, valid, scale)
    if d_out is None:
        return out.transpose(1, 2).reshape(B, S, dm)
    grads = _backward3(q, k, v, _heads(d_out, heads), lse, valid, scale)
    return torch.cat([g.transpose(1, 2).reshape(B, S, dm) for g in grads],
                     dim=-1)


@pytest.mark.parametrize("valid_len", [250, 201])
@pytest.mark.parametrize("direction,head_dim", [
    ("forward", 64), ("backward", 64), ("forward", 80), ("forward", 128),
    ("backward", 80), ("backward", 128)])
def test_three_pass_kernels_match_pallas_interpret(valid_len, direction,
                                                   head_dim):
    """The kernels' 3-pass arithmetic against the JAX package's kernels at
    "high" (interpret mode): the plain versions' bars, atol and rtol 1e-5
    forward, 5e-5 of each gradient's max backward (dP - dsum cancels)."""
    qkv = packed_qkv(2, 250, 2, head_dim, seed=11)
    dm = 2 * head_dim
    if direction == "forward":
        want = np.asarray(j_attention(jnp.asarray(qkv), 2, valid_len,
                                      q_blk=64, precision="high",
                                      interpret=True), np.float32)
        got = _attention3(torch.from_numpy(qkv), 2, valid_len).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    d_out = (np.random.default_rng(12).standard_normal((2, 250, dm))
             .astype(np.float32))
    _, vjp = jax.vjp(lambda x: j_diff(x, 2, valid_len, 64, "high", True),
                     jnp.asarray(qkv))
    want = np.asarray(vjp(jnp.asarray(d_out))[0], np.float32)
    got = _attention3(torch.from_numpy(qkv), 2, valid_len,
                      torch.from_numpy(d_out)).numpy()
    for i in range(3):
        sl = slice(i * dm, (i + 1) * dm)
        err = np.abs(got[..., sl] - want[..., sl]).max()
        assert err <= 5e-5 * np.abs(want[..., sl]).max(), ("qkv"[i], err)
    if valid_len < 250:
        assert not got[:, valid_len:, dm:].any()  # keys past valid_len


def test_three_pass_kernels_match_the_plain_version():
    """The tiled 3-pass arithmetic against ``attention_packed_plain`` and
    its backward at "high" (one pass over all keys, the plain versions the
    card holds the kernels to): the same bars."""
    qkv = torch.from_numpy(packed_qkv(1, 150, 2, 64, seed=13))
    d_out = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (1, 150, 128)).astype(np.float32))
    torch.testing.assert_close(
        _attention3(qkv, 2, 130),
        A.attention_packed_plain(qkv, 2, 130, precision="high"),
        atol=1e-5, rtol=1e-5)
    got = _attention3(qkv, 2, 130, d_out)
    want = A.attention_packed_bwd_plain(qkv, d_out, 2, 130, precision="high")
    for i in range(3):
        sl = slice(i * 128, (i + 1) * 128)
        err = (got[..., sl] - want[..., sl]).abs().max().item()
        assert err <= 5e-5 * want[..., sl].abs().max().item()


def test_three_passes_are_the_six_pass_tables_last_three():
    """hopper_common.cuh runs two planes' products as passes 3-5 of the
    6-pass table, smallest first: hi·lo (planes 0, 1), lo·hi (1, 0), hi·hi
    (0, 0); the CPU arithmetic above sums in that order."""
    common = (build.CSRC / "hopper_common.cuh").read_text()
    assert "return i == 0 || i == 4 ? 1 : i == 2 ? 2 : 0;" in common
    assert "return i == 0 || i == 3 ? 1 : i == 1 ? 2 : 0;" in common
    assert "return kP == 3 ? 0 : 3;" in common

    def pass_a(i):
        return 1 if i in (0, 4) else 2 if i == 2 else 0

    def pass_b(i):
        return 1 if i in (0, 3) else 2 if i == 1 else 0

    assert [(pass_a(i), pass_b(i)) for i in range(3, 6)] == [
        (0, 1), (1, 0), (0, 0)]


# ---------------------------------------------------------------- routes

@pytest.mark.parametrize("dtype,head_dim,precision,route", [
    (torch.float32, 64, "high", "3pass_wgmma"),
    (torch.float32, 64, "highest", "6pass"),
    (torch.float32, 64, None, "6pass"),
    (torch.float32, 80, "high", "3pass_wgmma"),
    (torch.float32, 80, None, "6pass"),
    (torch.float32, 128, "high", "3pass_wgmma"),
    (torch.float32, 128, None, "6pass"),
    (torch.bfloat16, 80, "high", "wgmma"),
    (torch.bfloat16, 128, None, "wgmma"),
    (torch.float32, 16, "high", "3pass"),
    (torch.float32, 16, "highest", "fma"),
    (torch.float32, 16, None, "fma"),
    (torch.bfloat16, 64, "high", "wgmma"),
    (torch.bfloat16, 64, "highest", "wgmma"),
    (torch.bfloat16, 64, None, "wgmma"),
    (torch.bfloat16, 16, "high", "mma"),
    (torch.bfloat16, 16, "highest", "mma"),
    (torch.bfloat16, 16, None, "mma"),
])
def test_route_table(dtype, head_dim, precision, route):
    assert A.kernel_route(dtype, head_dim, precision) == route
    assert (route in A.MAP_ROUTES) == ((dtype, head_dim) in A.TMA_ROUTES)


@pytest.mark.parametrize("route,counts", [("3pass_wgmma", (1, 1, 0))])
def test_launch_counters_count_both_3pass_routes(route, counts):
    for wrapper in (A.attention_packed, A.attention_packed_vv,
                    A.attention_kernel, A.attention_packed_bwd):
        before = (wrapper.launches, wrapper.launches_3pass,
                  wrapper.launches_6pass)
        try:
            A._count(wrapper, route)
            after = (wrapper.launches, wrapper.launches_3pass,
                     wrapper.launches_6pass)
            assert tuple(a - b for a, b in zip(after, before)) == counts
        finally:
            (wrapper.launches, wrapper.launches_3pass,
             wrapper.launches_6pass) = before


def test_every_wrapper_launches_the_3pass_route_on_split2_planes():
    import inspect

    for fn in (A._launch_forward, A.attention_kernel,
               A.attention_packed_bwd):
        src = inspect.getsource(fn)
        assert '"3pass_wgmma"' in src and "_planes(route, " in src
        assert "_kernels_3pass_wgmma()" in src
    assert "split2(" in inspect.getsource(A._planes)


@pytest.mark.parametrize("source,entry,loader,n_params", [
    ("attention_packed", "aaclip_attention_packed_3pass_wgmma", "fwd", 15),
    ("attention_packed", "aaclip_attention_bhsd_3pass_wgmma", "bhsd", 11),
    ("attention_packed_bwd", "aaclip_attention_packed_bwd_3pass_wgmma", "bwd",
     17),
    ("attention_packed", "aaclip_split2", "split", 5),
])
def test_3pass_wgmma_entry_points_match_the_c_signatures(source, entry,
                                                         loader, n_params):
    """One ctypes argument per parameter of each C entry point of the
    3-pass route at head dim 64 (``_kernels_3pass_wgmma``,
    ``_split_kernel``)."""
    import inspect

    src = (build.CSRC / f"{source}.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    assert "bf16" not in sig
    code = inspect.getsource(A._split_kernel if loader == "split"
                             else A._kernels_3pass_wgmma)
    argtypes = re.search(rf"{loader}\.argtypes = \[([^\]]*)\]",
                         code).group(1)
    assert len(argtypes.split(",")) == len(sig.split(",")) == n_params


def test_mma_sync_3pass_kernels_remain_at_head_dim_16_only():
    """The mma.sync 3-pass kernels are instantiated at head dim 16 alone:
    at 64, 80 and 128 the TMA + wgmma kernels took their place, and the
    mma.sync entry points refuse them (no fallback)."""
    fwd = (build.CSRC / "attention_packed.cu").read_text()
    bwd = (build.CSRC / "attention_packed_bwd.cu").read_text()
    assert "attn_fwd_3pass<16><<<" in fwd
    assert "attn_fwd_3pass<64>" not in fwd
    for name in ("attn_bwd_dq_3pass", "attn_bwd_dkdv_3pass"):
        assert f"{name}<16><<<" in bwd and f"{name}<64>" not in bwd
    assert "launch_3pass<64>" not in bwd
    assert fwd.count("if (head_dim != 16)") == 1
    assert bwd.count("if (head_dim != 16)") == 1
    for name in ("attn_fwd_3pass_wgmma<HD>", "split2_kernel"):
        assert f"{name}<<<" in fwd
    for name in ("attn_bwd_dq_3pass_wgmma<HD>",
                 "attn_bwd_dkdv_3pass_wgmma<HD>"):
        assert f"{name}<<<" in bwd


def test_shared_memory_attribute_is_set_once_per_kernel_and_device():
    """Every attention entry point raises its kernels' shared-memory limit
    through ``smem_attribute_once`` (one attribute call per kernel and
    device), never by calling ``cudaFuncSetAttribute`` per launch."""
    common = (build.CSRC / "hopper_common.cuh").read_text()
    assert "inline cudaError_t smem_attribute_once(" in common
    for name in ("attention_packed", "attention_packed_bwd"):
        src = (build.CSRC / f"{name}.cu").read_text()
        assert "cudaFuncSetAttribute" not in src
        assert src.count("smem_attribute_once(") >= 2

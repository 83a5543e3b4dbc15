"""The 6-pass route of the port's fp32 attention (precision "highest", the
CLIs' default ``--precision fp32``) on the CPU, where the wrappers run
their plain versions:

* ``split3_plain`` is exact: hi + mid + lo == x, bit for bit in fp64, on
  seeded random fp32 values over the documented domain |x| in [2^-110,
  0x1.fep127), powers of two, values near the largest and the smallest
  normals, and negative zero; NaN stays NaN; and below the domain the lo
  plane loses the bits under bf16's subnormal step, as documented;
* the six-product sum of two split operands (each bf16 product exact in
  fp32, summed in fp32) lies within 2^-20 of each output's max from the
  fp64 product at the attention's reduction depths 64 and 1370: the error
  model the on-card check relies on;
* the same six-product arithmetic through the attention forward and
  backward at head dims 64, 80 and 128 (the kernels' products, P and dS
  split, not rounded) against
  the JAX package's Pallas kernels in interpret mode at "highest" (true
  fp32 on the CPU): atol 1e-5, rtol 1e-5 as the plain versions' fp32 bar,
  and within 4e-6 of each output's max from fp64, the on-card bar;
* the route table (``kernel_route``), the launch counters, the C entry
  points' signatures, and the FMA head-dim-64 instantiations' removal.

The CUDA kernels themselves (``split3_kernel``, ``attn_fwd_6pass``,
``attn_bwd_{dq,dkdv}_6pass``) run only on the card: ``chip_smoke.py``
holds them against ``split3_plain`` bit for bit and against the plain
fp32 versions.
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
from aaclip_tpu_torch.ops import attention as A
from tests.test_torch_attention import packed_qkv

BF16_MAX = float.fromhex("0x1.fep127")  # hi rounds to inf from here


def _sum64(planes: torch.Tensor) -> torch.Tensor:
    """hi + mid + lo in fp64 (exact: three bf16 values of one fp32)."""
    hi, mid, lo = planes.double()
    return hi + mid + lo


def _random_in_domain(n: int, seed: int) -> np.ndarray:
    """Seeded fp32 values with full mantissas and both signs, spread over
    the binades of the exact domain."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, n)
    exp = rng.integers(-110, 127, n)
    sign = rng.choice([-1.0, 1.0], n)
    x = (sign * np.ldexp(mant, exp)).astype(np.float32)
    return x[np.abs(x) < BF16_MAX]


def _special(kind: str) -> np.ndarray:
    if kind == "random":
        return _random_in_domain(200_000, seed=0)
    if kind == "powers_of_two":
        p = np.ldexp(1.0, np.arange(-126, 128)).astype(np.float32)
        return np.concatenate([p, -p])
    if kind == "near_largest":
        top = np.float32(BF16_MAX)
        below = [np.nextafter(top, np.float32(0))]
        for _ in range(300):
            below.append(np.nextafter(below[-1], np.float32(0)))
        x = np.array(below + list(np.ldexp(np.linspace(1.0, 1.99, 200),
                                           127)), np.float32)
        return np.concatenate([x, -x])
    if kind == "near_smallest_normal":
        # the smallest normal 2^-126 and values whose bits stop at bf16's
        # subnormal step 2^-133, and full-mantissa values at the domain's
        # lower end 2^-110
        k = np.arange(128)
        low = np.ldexp(1.0 + k / 128.0, -126)
        edge = np.ldexp(np.random.default_rng(1).uniform(1.0, 2.0, 2000),
                        -110)
        x = np.concatenate([low, edge]).astype(np.float32)
        return np.concatenate([x, -x])
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "powers_of_two", "near_largest",
                                  "near_smallest_normal"])
def test_split3_is_exact_in_its_domain(kind):
    x = torch.from_numpy(_special(kind))
    planes = A.split3_plain(x)
    assert planes.shape == (3, *x.shape) and planes.dtype == torch.bfloat16
    total = _sum64(planes)
    assert torch.equal(total, x.double())
    # bit for bit: the fp64 sum's bits are x's widened bits
    assert torch.equal(total.view(torch.int64), x.double().view(torch.int64))
    # the planes step down by at least 8 bits each (hi is bf16(x))
    assert torch.equal(planes[0], x.to(torch.bfloat16))
    hi, mid, lo = planes.double().abs()
    nz = mid > 0
    assert bool((mid[nz] <= 2.0 ** -8 * hi[nz]).all())
    nz = lo > 0
    assert bool((lo[nz] <= 2.0 ** -8 * mid[nz]).all())


def test_split3_negative_zero_and_nan():
    x = torch.tensor([-0.0, 0.0, float("nan"), -float("nan")])
    planes = A.split3_plain(x)
    hi, mid, lo = planes.float()
    assert torch.signbit(hi[0]) and not torch.signbit(hi[1])
    assert float(mid[0]) == float(lo[0]) == 0.0
    assert float(_sum64(planes)[0]) == 0.0  # -0 + 0 + 0 == -0 as a value
    assert bool(torch.isnan(planes[:, 2:].float()).all())
    assert bool(torch.isnan(_sum64(planes)[2:]).all())


def test_split3_below_its_domain_drops_subnormal_bits():
    """Under 2^-110 the residuals fall below bf16's smallest subnormal
    step (2^-133) and lo drops them, as ``split3_plain`` documents: the
    lowest bit of 2^-126 * (1 + 2^-23) is 2^-149."""
    x = torch.tensor([np.float32(np.ldexp(1.0 + 2.0 ** -23, -126))])
    total = _sum64(A.split3_plain(x))
    assert float(total[0]) == 2.0 ** -126 != float(x.double()[0])
    assert abs(float(total[0]) - float(x.double()[0])) <= 2.0 ** -134


def _kdot6(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of fp32 tensors as the 6-pass kernels compute it: the six
    bf16 products hi·hi + hi·mid + mid·hi + hi·lo + lo·hi + mid·mid of
    ``split3_plain``'s planes (each product exact in fp32), summed in fp32
    in the kernels' order, smallest first: mid·mid, hi·lo, lo·hi, hi·mid,
    mid·hi, hi·hi."""
    pa = A.split3_plain(a).float()
    pb = A.split3_plain(b).float()
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for i, j in ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)):
        out = out + torch.matmul(pa[i], pb[j])
    return out


@pytest.mark.parametrize("depth", [64, 1370])
@pytest.mark.parametrize("kind", ["normal", "probabilities"])
def test_six_pass_product_is_fp32_accurate(depth, kind):
    """Q K^T (depth 64, the head dim) and P V (depth 1370, the keys) with
    normal operands, and with a softmax's probabilities as A: within 2^-20
    of the output's max from the fp64 product."""
    rng = np.random.default_rng(depth)
    a = rng.standard_normal((64, depth)).astype(np.float32)
    if kind == "probabilities":
        a = np.exp(a * 3.0)
        a = (a / a.sum(-1, keepdims=True)).astype(np.float32)
    b = rng.standard_normal((depth, 64)).astype(np.float32)
    got = _kdot6(torch.from_numpy(a), torch.from_numpy(b)).double()
    want = torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64))
    err = (got - want).abs().max().item()
    assert err <= 2.0 ** -20 * want.abs().max().item()


def _attention6(qkv: torch.Tensor, heads: int, valid: int,
                d_out: torch.Tensor | None = None) -> torch.Tensor:
    """The 6-pass kernels' arithmetic on a packed fp32 qkv: every product
    ``_kdot6``, P and dS in fp32 (split, never rounded), dO in fp32; the
    forward, or with ``d_out`` d(qkv)."""
    B, S, dm, hd, scale, offs = A._split(qkv, heads)

    def h(t):
        return t.reshape(B, S, heads, hd).transpose(1, 2)

    q, k, v = (h(qkv[..., o:o + dm]) for o in offs)
    s = _kdot6(q, k.transpose(-1, -2)) * scale
    s[..., valid:] = float("-inf")
    e = torch.exp(s - s.amax(-1, keepdim=True))
    if d_out is None:
        o = _kdot6(e, v) / e.sum(-1, keepdim=True)
        return o.transpose(1, 2).reshape(B, S, dm)
    p = e / e.sum(-1, keepdim=True)
    do = h(d_out)
    dp = _kdot6(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    grads = (_kdot6(ds, k), _kdot6(ds.transpose(-1, -2), q),
             _kdot6(p.transpose(-1, -2), do))
    return torch.cat([g.transpose(1, 2).reshape(B, S, dm) for g in grads],
                     dim=-1)


def _fp64(qkv: np.ndarray, heads: int, valid: int,
          d_out: np.ndarray | None = None) -> np.ndarray:
    """The exact function in fp64 (the autograd of the plain forward)."""
    x = torch.from_numpy(qkv).double().requires_grad_()
    out = A.attention_packed_plain(x, heads, valid)
    if d_out is None:
        return out.detach().numpy()
    (g,) = torch.autograd.grad(out, x, torch.from_numpy(d_out).double())
    return g.numpy()


@pytest.mark.parametrize("valid_len", [250, 201])
@pytest.mark.parametrize("direction,head_dim", [
    ("forward", 64), ("backward", 64), ("forward", 80), ("forward", 128),
    ("backward", 80), ("backward", 128)])
def test_six_pass_attention_matches_pallas_interpret(valid_len, direction,
                                                     head_dim):
    """The kernels' 6-pass arithmetic against the JAX package's kernels at
    "highest" (interpret mode, true fp32 on the CPU): the fp32 bar of the
    plain versions; and each output within 4e-6 of its max from fp64, the
    bar ``chip_smoke.py`` holds the card's kernels to."""
    qkv = packed_qkv(2, 250, 2, head_dim, seed=7)
    dm = 2 * head_dim
    d_out = (np.random.default_rng(8).standard_normal((2, 250, dm))
             .astype(np.float32) if direction == "backward" else None)
    if d_out is None:
        want = np.asarray(j_attention(jnp.asarray(qkv), 2, valid_len,
                                      q_blk=64, precision="highest",
                                      interpret=True), np.float32)
        got = _attention6(torch.from_numpy(qkv), 2, valid_len).numpy()
    else:
        _, vjp = jax.vjp(lambda x: j_diff(x, 2, valid_len, 64, "highest",
                                          True), jnp.asarray(qkv))
        want = np.asarray(vjp(jnp.asarray(d_out))[0], np.float32)
        got = _attention6(torch.from_numpy(qkv), 2, valid_len,
                          torch.from_numpy(d_out)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    exact = _fp64(qkv, 2, valid_len, d_out)
    for sl in ((slice(None),) if d_out is None else
               [slice(i * dm, (i + 1) * dm) for i in range(3)]):
        err = np.abs(got[..., sl] - exact[..., sl]).max()
        assert err <= 4e-6 * np.abs(exact[..., sl]).max()


# ---------------------------------------------------------------- routes

@pytest.mark.parametrize("dtype,head_dim,precision,route", [
    (torch.float32, 64, "highest", "6pass"),
    (torch.float32, 64, None, "6pass"),
    (torch.float32, 64, "high", "3pass_wgmma"),
    (torch.float32, 80, "highest", "6pass"),
    (torch.float32, 128, None, "6pass"),
    (torch.bfloat16, 80, None, "wgmma"),
    (torch.bfloat16, 128, "highest", "wgmma"),
    (torch.float32, 16, "highest", "fma"),
    (torch.float32, 16, None, "fma"),
    (torch.float32, 16, "high", "3pass"),
    (torch.bfloat16, 64, None, "wgmma"),
    (torch.bfloat16, 64, "high", "wgmma"),
    (torch.bfloat16, 64, "highest", "wgmma"),
    (torch.bfloat16, 16, None, "mma"),
    (torch.bfloat16, 16, "high", "mma"),
])
def test_kernel_route(dtype, head_dim, precision, route):
    assert A.kernel_route(dtype, head_dim, precision) == route


def test_every_wrapper_launches_by_the_route():
    import inspect

    for fn in (A._check_cuda, A.attention_kernel):
        assert "kernel_route(" in inspect.getsource(fn)
    for fn in (A._launch_forward, A.attention_kernel,
               A.attention_packed_bwd):
        src = inspect.getsource(fn)
        assert '"6pass"' in src and "_planes(route, " in src
        assert "_kernels_6pass()" in src
    planes = inspect.getsource(A._planes)
    assert '"6pass"' in planes and "split3(" in planes


@pytest.mark.parametrize("route,counts", [
    ("6pass", (1, 0, 1)), ("3pass", (1, 1, 0)), ("wgmma", (1, 0, 0)),
    ("fma", (1, 0, 0)), ("mma", (1, 0, 0))])
def test_launch_counters_by_route(route, counts):
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


@pytest.mark.parametrize("source,entry,loader,n_params", [
    ("attention_packed", "aaclip_attention_packed_6pass", "fwd", 15),
    ("attention_packed", "aaclip_attention_bhsd_6pass", "bhsd", 11),
    ("attention_packed_bwd", "aaclip_attention_packed_bwd_6pass", "bwd", 17),
    ("attention_packed", "aaclip_split3", "split", 5),
])
def test_6pass_entry_points_match_the_c_signatures(source, entry, loader,
                                                   n_params):
    """One ctypes argument per parameter of each C entry point of the
    6-pass route (``_kernels_6pass``, ``_split_kernel``)."""
    import inspect

    src = (build.CSRC / f"{source}.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    assert "bf16" not in sig
    code = inspect.getsource(A._split_kernel if loader == "split"
                             else A._kernels_6pass)
    argtypes = re.search(rf"{loader}\.argtypes = \[([^\]]*)\]",
                         code).group(1)
    assert len(argtypes.split(",")) == len(sig.split(",")) == n_params


def test_fma_kernels_remain_at_head_dim_16_only():
    """The fp32 FMA kernels are instantiated at head dim 16 alone: at 64,
    80 and 128 the 6-pass kernels took their place, and the retained entry
    points refuse fp32 there (no fallback)."""
    fwd = (build.CSRC / "attention_packed.cu").read_text()
    bwd = (build.CSRC / "attention_packed_bwd.cu").read_text()
    assert "attn_f32_kernel<16>" in fwd and "attn_f32_kernel<64>" not in fwd
    assert "launch_retained<16, false>" in bwd
    assert "launch_retained<64, false>" not in bwd
    assert "!bf16 && head_dim == 64" not in fwd + bwd
    for name in ("attn_fwd_6pass<HD>", "split3_kernel"):
        assert f"{name}<<<" in fwd
    for name in ("attn_bwd_dq_6pass<HD>", "attn_bwd_dkdv_6pass<HD>"):
        assert f"{name}<<<" in bwd


@pytest.mark.parametrize("shape", [(2, 37, 384), (5,), (3, 1, 7)])
def test_split3_takes_the_plain_version_on_the_cpu(shape):
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(shape)
                         .astype(np.float32))
    before = A.split3.launches
    assert torch.equal(A.split3(x), A.split3_plain(x))
    assert A.split3.launches == before

"""The 6-pass route of the port's fused block (fp32 under precision
"highest", ``DtypePolicy.fp32()``, the parity policy) on the CPU, where
the wrappers run their plain versions:

* the GEMM's error model, a torch emulation of the kernel's arithmetic
  (not the port's code): ``split3_plain``'s planes, the six bf16 products
  of the pass table (each exact in fp32) of a 64-deep k-tile summed into a
  fresh fp32 accumulator, smallest first, and each k-tile's sum added to
  the running fp32 sum, as ``gemm_planes_wgmma<3, EPI>`` does; within
  4e-6 and 1e-6 of each output's max from fp64 (the bars
  ``chip_smoke.py`` holds the card's kernels to) at the reduction depths
  of the block (K 1024 and proj's 4096) and widths up to 1024, where the
  3-pass mode's emulation misses the 1e-6;
* the route table (FP32 on the engine, its tiles and planes), the launch
  counters, the ``kModeF32`` dispatch and the ring of the 6-pass GEMM read
  from the source, the FMA kernels' removal, and
  ``fused_block_supported`` under fp32 at ViT-B's width 768, which the FMA
  MLP did not take.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` phase 8
holds them against the plain versions and fp64. The plain versions are
held against the JAX package's kernels by ``test_torch_fused_block.py``.
"""

import re

import numpy as np
import pytest
import torch

from aaclip_tpu_torch.core.config import DtypePolicy, get_config
from aaclip_tpu_torch.kernels import build
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.ops import fused_block as FB
from aaclip_tpu_torch.ops.attention import split2_plain, split3_plain

SIX_FP64_OF_MAX = 4e-6        # chip_smoke.py's SIX_FP64_MAX_REL
SIX_FUSED_FP64_OF_MAX = 1e-6  # chip_smoke.py's SIX_FUSED_FP64_MAX_REL
BK = 64                       # fused_block.cu's kBK
# the pass table of hopper_common.cuh (pass_a, pass_b), smallest first:
# mid.mid, hi.lo, lo.hi, hi.mid, mid.hi, hi.hi; the 3-pass mode runs the
# last three on two planes (hi, lo)
PASSES = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))
PASSES_3 = ((0, 1), (1, 0), (0, 0))


def gemm_planes(a: torch.Tensor, w: torch.Tensor,
                planes: int = 3) -> torch.Tensor:
    """``a @ w.T`` (a [R, K], w [N, K], fp32) as the split-plane GEMM
    computes it: per k-tile of BK columns the products of the planes in
    the pass table's order (six on three planes, three on two) into a
    fresh fp32 sum, added to the running one."""
    split, passes = (split3_plain, PASSES) if planes == 3 else \
        (split2_plain, PASSES_3)
    pa, pw = split(a).float(), split(w).float()
    acc = torch.zeros(a.shape[0], w.shape[0])
    for k0 in range(0, a.shape[1], BK):
        ks = slice(k0, k0 + BK)
        part = torch.zeros_like(acc)
        for i, j in passes:
            part = part + pa[i][:, ks] @ pw[j][:, ks].T
        acc = acc + part
    return acc


def rand(rng, *shape, s=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * s)
                            .astype(np.float32))


def of_max(got: torch.Tensor, exact: torch.Tensor) -> float:
    """max |got - exact| as a fraction of max |exact|."""
    return ((got.double() - exact).abs().max()
            / exact.abs().max()).item()


@pytest.mark.parametrize("k,n", [(1024, 1024), (1024, 384), (4096, 1024)])
def test_six_pass_gemm_is_fp32_accurate(k, n):
    """The GEMM alone: LayerNorm-scaled rows (unit variance) against CLIP's
    weight scale (K^-1/2), the QKV / out-projection depth 1024 and proj's
    4096, within 4e-6 and 1e-6 of the output's max from fp64; the 3-pass
    mode's three products on two planes miss the 1e-6, so that bar tells
    the two modes apart."""
    rng = np.random.default_rng(k + n)
    a, w = rand(rng, 64, k), rand(rng, n, k, s=k ** -0.5)
    exact = a.double() @ w.double().T
    six = of_max(gemm_planes(a, w), exact)
    assert six <= min(SIX_FP64_OF_MAX, SIX_FUSED_FP64_OF_MAX), six
    three = of_max(gemm_planes(a, w, planes=2), exact)
    assert three > SIX_FUSED_FP64_OF_MAX, three
    # the six passes are what reaches fp32: hi.hi alone (a bf16 product)
    # misses the bar by orders of magnitude
    hi = (a.bfloat16().float() @ w.bfloat16().float().T).double()
    assert of_max(hi, exact) > 100 * SIX_FP64_OF_MAX


D, F, B, S = 128, 512, 2, 21


@pytest.fixture(scope="module")
def block():
    rng = np.random.default_rng(11)
    return dict(x=rand(rng, B, S, D), g=1 + rand(rng, D, s=0.1),
                b=rand(rng, D, s=0.1), w=rand(rng, 3 * D, D, s=D ** -0.5),
                bias=rand(rng, 3 * D, s=0.02), y=rand(rng, B, S, D),
                w_fc=rand(rng, F, D, s=D ** -0.5), b_fc=rand(rng, F, s=0.02),
                w_proj=rand(rng, D, F, s=F ** -0.5),
                b_proj=rand(rng, D, s=0.02))


# ---------------------------------------------------------------- routes

def test_fp32_route_is_the_engines_6pass_mode():
    assert FB.route(torch.float32, "highest") == FB.route(torch.float32,
                                                          None) == FB.FP32
    assert FB.FP32 in FB.TMA_ROUTES
    assert FB.TMA_ROUTES == {FB.BF16, FB.HIGH, FB.FP32}
    assert FB._GEMM_TILES[FB.FP32] == FB._GEMM_TILES[FB.BF16] == (128, 64)
    assert FB.PLANES == {FB.HIGH: 2, FB.FP32: 3}
    assert not hasattr(FB, "KERNEL_MLP_WIDTHS")
    assert not hasattr(FB, "KERNEL_MLP_HIDDEN_TILE")
    for n, k, ln, ok in ((3072, 1024, True, True), (384, 128, True, True),
                         (1024, 4096, False, True),
                         (3072, 2048, True, False),  # LN row over the cap
                         (192, 64, True, False), (1024, 96, False, False)):
        assert FB._gemm_widths_ok(FB.FP32, n, k, ln) is ok
    for d, f, ok in ((1024, 4096, True), (768, 3072, True), (128, 512, True),
                     (64, 256, False), (1280, 5120, False),
                     (768, 3136, False)):
        assert FB._mlp_widths_ok(FB.FP32, d, f) is ok


def test_fp32_supports_vit_b_width_768():
    """ViT-B-16's width (768, MLP 3072) is on the 6-pass route now, where
    the FMA MLP took only 128 and 1024; tiny-test's 64 stays refused."""
    fp32 = DtypePolicy.fp32()
    for name in ("ViT-B-16", "ViT-B-16-quickgelu", "ViT-L-14-336"):
        assert FB.fused_block_supported(get_config(name), fp32)
    assert not FB.fused_block_supported(get_config("tiny-test"), fp32)


@pytest.mark.parametrize("key,counts", [(FB.FP32, (1, 0, 1)),
                                        (FB.HIGH, (1, 1, 0)),
                                        (FB.BF16, (1, 0, 0))])
def test_launch_counters_by_route(key, counts):
    for wrapper in (FB.ln_linear, FB.linear_residual, FB.mlp_fused):
        before = (wrapper.launches, wrapper.launches_3pass,
                  wrapper.launches_6pass)
        try:
            FB._count(wrapper, key)
            after = (wrapper.launches, wrapper.launches_3pass,
                     wrapper.launches_6pass)
            assert tuple(a - b for a, b in zip(after, before)) == counts
        finally:
            (wrapper.launches, wrapper.launches_3pass,
             wrapper.launches_6pass) = before


def test_fp32_block_on_the_cpu_counts_no_launch(block):
    t = block
    fp32 = DtypePolicy.fp32()
    wrappers = (FB.ln_linear, FB.linear_residual, FB.mlp_fused)
    before = [(w.launches, w.launches_6pass) for w in wrappers]
    FB.ln_linear(t["x"], t["g"], t["b"], t["w"], t["bias"], fp32)
    FB.linear_residual(t["x"], t["y"], t["w"][:D], t["bias"][:D], fp32)
    FB.mlp_fused(t["x"], t["g"], t["b"], t["w_fc"], t["b_fc"], t["w_proj"],
                 t["b_proj"], L.gelu, fp32)
    assert before == [(w.launches, w.launches_6pass) for w in wrappers]


SRC = build.CSRC / "fused_block.cu"


def _const(src: str, name: str) -> int:
    """A constexpr int of the source: a number or a product of numbers."""
    expr = re.search(rf"\b{name} = ([\d *]+)[;,]", src).group(1)
    return int(np.prod([int(f) for f in expr.split("*")]))


def test_fma_kernels_are_gone():
    """No FMA fused-block kernel remains: every fp32 width the port runs
    (the engine's) is on the 6-pass mode, so nothing reaches one."""
    src = SRC.read_text()
    for name in ("gemm_f32_kernel", "mlp_f32_kernel", "launch_gemm_f32",
                 "launch_mlp_f32", "gemm_f32_shape_ok", "kFBN", "kFHid"):
        assert name not in src
    kernels = set(re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", src))
    assert kernels == {"row_stats_kernel", "gemm_wgmma", "split_kernel",
                       "ln_split_kernel", "gemm_planes_wgmma"}


def test_six_pass_ring_fits_shared_memory():
    """The split-plane GEMM's ring: kPlaneRing bytes of stages of 2 kP
    tiles (128 rows of A, kBN of W, kBK columns each): the 3-pass mode's
    three 64 KB stages as before, the 6-pass mode's two 96 KB stages, each
    block's shared memory (ring, mbarriers, the alignment slack) within
    the 232,448 bytes a block may use."""
    src = SRC.read_text()
    ring, bm, bn, bk = (_const(src, n)
                        for n in ("kPlaneRing", "kBM", "kBN", "kBK"))
    assert bk == BK
    for planes, stages in ((2, 3), (3, 2)):
        stage = planes * (bm + bn) * bk * 2
        assert ring // stage == stages
        assert 1024 + stages * stage + 16 * stages <= 232_448
    assert "kBKShallow" not in src and "6pass_k_tile" not in src
    # the 6-pass chain runs the pass table from its first pass, smallest
    # first, into a fresh accumulator added to the running sum
    assert "for (int i = first; i < 6; ++i)" in src
    assert "acc[i] += part[i];" in src
    assert "first_pass<kP>()" in src


def test_kmode_f32_dispatches_to_the_6pass_mode():
    """Each C entry point checks the engine's widths first, then sends
    kModeF32 to its split-plane route on three planes and kMode3Pass to
    the same route on two, before the bf16 GEMM; each split-plane route
    launches the splits and then the GEMM on its planes."""
    src = SRC.read_text()

    def body(start_marker, end_marker="\n}\n"):
        start = src.index(start_marker)
        return src[start:src.index(end_marker, start)]

    for entry, route in (("aaclip_ln_linear", "ln_linear_planes"),
                         ("aaclip_linear_residual",
                          "linear_residual_planes"),
                         ("aaclip_mlp_fused", "mlp_planes")):
        b = body(f'extern "C" int {entry}(')
        at = [b.index(m) for m in (
            "tma_shape_ok(", "if (mode == kModeF32)", f"return {route}<3>(",
            "if (mode == kMode3Pass)", f"return {route}<2>(",
            "launch_tma_gemm<")]
        assert at == sorted(at), entry
        assert "launch_planes_gemm" not in b and "launch_split" not in b
    for route, calls in (
            ("ln_linear_planes", ("launch_split<kP>(", "launch_ln_split<kP>(",
                                  "launch_planes_gemm<kP, kEpiBias>")),
            ("linear_residual_planes",
             ("launch_split<kP>(", "launch_planes_gemm<kP, kEpiResidual>")),
            ("mlp_planes", ("launch_split<kP>(", "launch_ln_split<kP>(",
                            "launch_planes_gemm<kP, kEpiAct>",
                            "launch_planes_gemm<kP, kEpiProj>"))):
        b = body(f"int {route}(")
        at = [b.index(c) for c in calls]
        assert at == sorted(at), route

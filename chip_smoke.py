"""On-card smoke test of the PyTorch/CUDA port (``aaclip_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases, each of which fails the run:
 1. the card's name and power limit (nvidia-smi);
 2. build every kernel from the sources in ``aaclip_tpu_torch/kernels/
    csrc``, one nvcc per source started together, and print nvcc's
    register and spill report for every instantiation, with ptxas's
    C75xx notes on serialized wgmma products;
 3. hold each kernel against its plain PyTorch version on the card, at the
    main paths' shapes, at ragged sequence lengths, at the edges of the
    TMA + wgmma kernels' 128-row tiles (S 128, 129, 256, valid_len 128 of
    200, a batch of 3 at S 200) and at head dim 16, in bf16 and fp32: the
    forward attention, its logsumexp output against ``torch.logsumexp`` of
    the plain scores, the backward kernel's dq, dk and dv (and two runs of
    it bit for bit), a batch whose image 1 is NaN (images 0 and 2 as with
    image 1 zero, bit for bit, in every attention launch), and the bf16
    ``matmul_f32`` gradients against fp64;
 4. the inference path (ViT-L-14-336 @ 518 px, random weights from a seed)
    through ``make_predict_fn``: bf16 with uint8 inputs at batch 8 and fp32
    at batch 2, each against the same predictor with the plain attention,
    counting kernel launches; bf16 against fp32 on the same images (printed,
    the scale of bf16's own rounding); and tiny-test on the card against
    the CPU;
 5. the stage-2 training step (the same model, bf16) through
    ``make_stage2_step``: at batch 2 with remat, the kernel step against the
    plain-attention step from the same adapter (loss and every adapter
    gradient), counting 47 forward and 23 backward launches; five kernel
    steps at batch 8 without remat, counting 24 forward and 23 backward
    launches per step, losses finite, peak device memory printed;
    tiny-test fp32 steps on the card against the CPU;
 6. time, with CUDA events: the forward kernel, its plain version and
    torch's SDPA at the predict's attention shape, and the predict in
    maps/s with the kernel and with the plain attention; the backward
    kernel, its plain version and the backward of SDPA at the training
    step's shape, and the step in images/s at batch 8;
 7. the stage-1 path (the same model, bf16, VisA's 12 classes through the
    12-layer text tower): (a) spatial features at batch 2 with the kernels
    against the same features with both attentions plain, counting 24
    standard and 19 V-V launches per call; (b) batch-mode features, 24
    standard and 0 V-V launches; (c) five iterations at batch 16 from
    spatial features, losses finite, peak device memory printed; (d) one
    step from kernel features against one from plain features, from the
    same text adapter (loss, each gradient's cosine and norm); (e)
    tiny-test fp32 features and step on the card against the CPU; then
    the V-V kernel, its plain version and SDPA on the V views at the
    bench's [16, 1370, 1024], and stage-1 images/s at batch 16 in both
    V-V modes.
 8. the fused-block path (``ops/fused_block.py``, ``fused_block.cu``; bf16
    on the TMA + wgmma GEMM, fp32 on the FMA kernels): (a) ``ln_linear``
    (B5, to 3D and D columns), ``linear_residual`` (B6) and ``mlp_fused``
    (B7, under each activation) against their plain versions in bf16 and
    fp32, each kernel run twice bit for bit, at the predict's batch-32
    rows, a ragged row count, the GEMM's 128-row tile edges (128, 129 and
    255 rows), ViT-B-16's width 768 (hidden 3072; the fp32 MLP has no
    kernel there and says so) and width 128; then one NaN row of x (and of
    B6's input) in a [3, 200, 1024] batch, which must leave every other
    row of each output bit for bit as with that row zero; (b)
    ``attention_kernel`` (B4, the forward kernel on the [B, H, S, hd]
    layout) against its plain version at [32, 16, 1370, 64], ragged S
    with valid_len < S and head dim 16, and bit for bit against
    ``attention_packed`` on the same values packed; (c)
    the predict with ``block_fn=make_block_fn(...)`` (bf16 uint8 at batch
    8, fp32 at batch 2) against the same predictor on the plain-version
    block with phase 4's bars, 24 launches per call of each of
    ``ln_linear``, ``attention_packed``, ``linear_residual`` and
    ``mlp_fused`` and none of ``attention_kernel``, and (printed) its
    distance from the unfused predictor;
    (d) ``encode_image`` with ``block_fn`` and ``vv_block_fn`` from
    ``vv_start`` 5 (bf16, batch 2) against the plain blocks, counting 24
    ``ln_linear`` (5 to 3072 columns, 19 to 1024), 5 standard + 19 V-V
    attention, 24 ``linear_residual`` and 24 ``mlp_fused`` launches, and a
    width-128 3-layer tower in fp32 on the card against the CPU; (e) CUDA-
    event times at the batch-32 shapes of each kernel, its plain version
    and the library yardstick (the unfused sequence the predict runs for
    B5-B7, SDPA for B4), each bf16 GEMM with output tiles of the source's
    own width, of 128 and of 256 columns (ms per call, and per GEMM launch
    from torch.profiler), and the fused predict's maps/s beside the
    unfused one's.
 9. the evaluation CLI from checkpoints (``python -m aaclip_tpu_torch.test``
    through ``main``): a seeded ViT-L-14-336 at its native 336 px saved as
    an OpenAI-layout state dict (the loader resizes the positional
    embedding 24 -> 37), an npz image adapter and a reference ``.pth``
    text adapter, a synthetic MVTec set (2 classes, 24 normal and 24
    anomalous 256 px images each); the CLI at bf16 batch 32 and at fp32
    batch 8 with ``--csv --dump_scores``, each held to (a) 24 forward
    kernel launches per predict batch and no other kernel, (b) its
    ``scores_1.csv`` bit for bit against a direct ``make_predict_fn`` on
    the same loaded towers and batches, (c) the same loop on the plain
    attention (maps, scores and the metric table, both tables printed);
    then (d) the 3-pass ``M q Mᵀ`` against fp64; with the CLI's logged
    maps/s, the host's decode+resize ms per image and the checkpoint's
    save and load seconds.
Phase 3 also holds the V-V mode of the forward kernel (B3) against its
plain version, in bf16 and fp32, at [16, 1370, 1024], ragged S and head
dim 16, and against the standard mode on the value section tripled.
Then it prints the kernel table as one JSON line (``launches`` counts the
wrapper's calls on the main path; B4's is read after the fused predict,
where it must be 0, since no path runs B4; ``ms`` is per call;
``kernels_per_call`` is counted at the library's launch sites in one call
at the timed shape, and torch.profiler must see no device operation but
those kernels in three calls, no cast or copy: 1 for the forward, 2 for
the backward (a dQ and a dK/dV kernel), 2 for ``ln_linear`` (row
statistics, GEMM), 1 for ``linear_residual``, 3 for ``mlp_fused``
(statistics, fc, proj)), the card line, and the result line ``{"ok":
true, "device": {...}}`` last. Exits non-zero without a result
when there is no card.
"""

from __future__ import annotations

import copy
import functools
import json
import sys
import time
from types import SimpleNamespace

# bf16 kernel vs plain: P is rounded to bf16 against the running max of
# the online softmax, not the row's final max, and the output is rounded
# to bf16 (2^-8 relative): entries may differ by a few output ulps.
BF16_MAX_ABS, BF16_MEAN_ABS = 2e-2, 2e-3
# fp32 kernel vs plain: both fp32 end to end; only the summation order and
# the online rescaling differ, ~1e-6 relative.
FP32_MAX_ABS = 1e-4
# logsumexp, fp32 in both: __expf's approximation and another summation
# order move the row sum by ~1e-6 relative, lse (~10) by ~1e-5.
LSE_MAX_ABS = 1e-4
# backward kernel vs plain, relative to each gradient's max |value|. bf16:
# both round P for dV, dS, and the outputs to bf16 at the same points, but
# P = exp(s - lse) and e / sum(e) differ by fp32 ulps, so a rounding may
# flip by one bf16 ulp (2^-8) and the output by one ulp of its binade:
# max 2^-6 of the max (two top-binade ulps, with room for the flipped
# terms' sums), mean 2^-10. fp32: the same arithmetic in another order
# over ~1370-term sums, ~1e-6 relative: max 2e-5 of the max.
BWD_BF16_MAX_REL, BWD_BF16_MEAN_REL = 2 ** -6, 2 ** -10
BWD_FP32_MAX_REL = 2e-5
# bf16 matmul_f32 gradients against fp64 of the same bf16 operands: the
# card rounds the cotangent to bf16 and then each gradient to bf16, two
# roundings of 2^-8 relative each: 2^-6 of the gradient's max.
MM_GRAD_MAX_REL = 2 ** -6
# predict, bf16: the attention rounding above moves each of 24 blocks'
# bf16 residual stream by a few ulps; the map may move by a fraction of a
# percent of its span and the scores by well under 5e-3.
PIX_SPAN_FRAC_BF16, SCORE_ATOL_BF16 = 1e-2, 5e-3
# predict, fp32: the kernel's ~1e-6 relative error carried through 24 fp32
# blocks, the projections and the 100x similarity scale.
PIX_ATOL_FP32, PIX_RTOL_FP32, SCORE_ATOL_FP32 = 1e-3, 1e-4, 1e-4
# tiny-test, card (kernel, cuBLAS fp32) vs CPU (plain), fp32 parity policy.
TINY_ATOL, TINY_RTOL = 1e-4, 1e-5
# stage-2 step, bf16 ViT-L, kernel vs plain attention from one adapter:
# the forward and backward kernels each differ from their plain versions
# by about one bf16 ulp per block (phase 3), carried through 24 bf16
# blocks both ways. Read on an NVIDIA H100 80GB HBM3, 700 W: loss 2.8e-5
# relative, every adapter gradient's cosine >= 0.99995 and norm within
# 3.9e-3. Bars about 10x above: loss 5e-4 relative, cosine >= 0.9995
# (1 - cos ten times the reading's), norm within 2e-2.
STEP_LOSS_RTOL, STEP_GRAD_COS, STEP_GRAD_NORM_RTOL = 5e-4, 0.9995, 2e-2
# tiny-test stage-2 step, fp32, card vs CPU: the same fp32 math through
# kernels and cuBLAS in another summation order.
TINY_STEP_LOSS_RTOL, TINY_STEP_GRAD_REL = 1e-5, 1e-4

# stage-1 spatial features, bf16 ViT-L at batch 2, kernels vs both
# attentions plain: each kernel is within about a bf16 ulp of its plain
# version, carried through 24 standard and 19 V-V blocks (the features are
# a unit patch vector plus the unit CLS vector). Read on an NVIDIA H100
# 80GB HBM3, 700 W: max |d| 3.346e-3, least per-token cosine 0.99991481.
# Bars about 10x above: max |d| 3.3e-2, 1 - cosine 1e-3.
S1_FEAT_MAX_ABS, S1_FEAT_COS = 3.3e-2, 0.999
# stage-1 step from kernel features vs from plain features, same adapter:
# the 100x similarity scores carry that feature difference into the loss.
# Read on the same card: loss 2.803e-3 relative, each text-adapter
# gradient's cosine >= 0.99981563 and norm within 3.032e-2. Bars about 10x
# above: loss 3e-2 relative, 1 - cosine 2e-3, norm within 0.3.
S1_STEP_LOSS_RTOL, S1_STEP_GRAD_COS, S1_STEP_GRAD_NORM_RTOL = 3e-2, 0.998, 0.3
# tiny-test stage-1, fp32, card vs CPU: features as TINY_*; the step as
# TINY_STEP_*.

# Phase 8. B5-B7 kernel vs plain, bf16: both round the normalised rows,
# the MLP's hidden and the output to bf16 at the same points and sum in
# fp32 in another order (~1e-6 relative), which can flip an output
# rounding by one bf16 ulp (at most 2^-7 of the value); a flipped rounding
# inside (a normalised or hidden element) moves the output by a small
# fraction of that. Per element |d| <= 2^-7 |plain| + 2^-10 max |plain|,
# mean |d| <= 2^-10 mean |plain|. (Read on an NVIDIA H100 80GB HBM3,
# 700 W, on the TMA + wgmma GEMM at the batch-32 rows: ln_linear max
# 1.562e-2, one ulp at [2, 4), mean 8.2e-7; mlp_fused max 3.125e-2, one
# ulp at [4, 8), mean 2.7e-6; linear_residual 0: it sums in cuBLAS's order
# there. The tile edges, ragged rows and width 768 read no more.)
FUSED_BF16_REL, FUSED_BF16_OF_MAX, FUSED_BF16_MEAN = 2 ** -7, 2 ** -10, \
    2 ** -10
# fp32: the same fp32 arithmetic in another order over 128-4096 terms, and
# erff/tanhf/expf against torch's (an ulp or two): ~1e-6 of the output's
# max |value| (read: at most 1.8e-6 of it); bar 1e-5 of it.
FUSED_FP32_OF_MAX = 1e-5
# B4 against its plain version: the bars of the forward kernel (BF16_*,
# FP32_MAX_ABS), whose arithmetic it is; against attention_packed on the
# same values: bit for bit. The fused predict against the plain-block
# predict: phase 4's bars (PIX_*, SCORE_*; read on the same card: bf16 map
# 7.763e-3 of its span, scores 1.9e-5). That bar cannot tell the fused
# chain from the unfused one, and no bar on the map can: 24 bf16 blocks
# spread any moved rounding over the whole map, so the fused and unfused
# predicts sit about as far from the plain-block one (max 7.763e-3 against
# 8.850e-3 of the span, mean 1.307e-3 against 1.511e-3). It catches gross
# faults only; the per-kernel bars of 8a and the encode_image cosines
# carry the check. encode_image, fused blocks against
# plain blocks: the kernels' ulp-level differences through 24 blocks, as
# the stage-1 features (S1_FEAT_COS): every tap token's and the pooled
# embedding's cosine >= 0.999 (read: least 0.99988777); the width-128
# tower in fp32, card vs CPU: TINY_*.
ENC_COS = 0.999

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12  # HBM3
TRAIN_BATCH = 8
STAGE1_BATCH = 16  # the reference's text batch (train.py:35)
STAGE1_SURGERY_UNTIL = 20  # train.py's default: V-V from block 5 of 24


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ops(fn, calls: int = 1) -> dict:
    """The device operations (kernels, copies, fills) of ``calls`` calls of
    ``fn`` under torch.profiler: {name: (count, device microseconds)}.
    One call runs first as the profiler's warm-up step, traced and
    discarded: a trace can miss the work at its very start."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation}


# (fn, want, what) of every kernels_per_call, for check_device_ops
DEVICE_OPS_CHECKS = []


def kernels_per_call(fn, lib: str, want: dict, what: str) -> int:
    """The kernels one call of ``fn`` launches, counted by library ``lib``
    at its launch sites (``kernels_launched``), which must be ``want``'s
    total ({a kernel name's part: launches per call}); queues ``fn`` for
    ``check_device_ops``."""
    import torch

    from aaclip_tpu_torch.kernels.build import kernels_launched

    before = kernels_launched(lib)
    fn()
    torch.cuda.synchronize()
    n = kernels_launched(lib) - before
    print(f"{what}: {n} kernels per call (counted at the launch sites)")
    expect(n == sum(want.values()),
           f"{what} launches {n} kernels per call, not {want}")
    DEVICE_OPS_CHECKS.append((fn, want, what))
    return n


def check_device_ops() -> None:
    """The device operations of three calls of each function
    ``kernels_per_call`` counted, under torch.profiler: each must be one of
    its kernels, so that no cast, copy or fill rides along. The library
    counts and the profiler only names: a trace can miss a kernel (the
    attention backward's first, in one of three traces on the H100). Run
    after every timed phase: the host-bound stage-1 and stage-2 rates read
    2-5% lower in runs that had traced before them."""
    for fn, want, what in DEVICE_OPS_CHECKS:
        seen = {}
        for name, (count, _) in device_ops(fn, 3).items():
            part = next((p for p in want if p in name), name)
            seen[part] = seen.get(part, 0) + count
        print(f"{what}: device operations of 3 calls (profiler): {seen}")
        expect(set(seen) <= set(want),
               f"{what} runs {sorted(set(seen) - set(want))} beside its "
               f"kernels")
    DEVICE_OPS_CHECKS.clear()


def expect(cond: bool, what: str) -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not cond:
        raise AssertionError(what)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    return max((flops / H100_BF16_FLOPS * 1e3, "operations"),
               (nbytes / H100_BYTES_PER_S * 1e3, "bytes"))


def random_qkv(B, S, H, hd, dtype, gen):
    import torch

    x = torch.randn(B, S, 3 * H * hd, generator=gen, device="cuda")
    return x.to(dtype)


# (B, S, heads, head dim, valid_len)
KERNEL_CASES = [
    (2, 1370, 16, 64, 1370),   # ViT-L/518
    (8, 1370, 16, 64, 1370),   # ViT-L/518 at the predict and train batch
    (2, 77, 16, 64, 77),       # ragged: one partial tile
    (2, 257, 16, 64, 257),     # ragged: 4 full tiles + 1 row
    (2, 257, 16, 64, 200),     # keys past valid_len masked
    (3, 26, 4, 16, 26),        # tiny-test geometry, head dim 16
    (2, 257, 2, 16, 257),      # head dim 16, ragged
    # the 128-row tiles of the TMA + wgmma kernels (64-row streamed tiles
    # in the backward): exactly one tile, one row over, two tiles, keys
    # masked at a tile edge, and a batch of 3 whose images' tail tiles end
    # mid-tile (TAIL_CASE below also poisons image 1)
    (2, 128, 16, 64, 128),
    (2, 129, 16, 64, 129),
    (2, 256, 16, 64, 256),
    (2, 200, 16, 64, 128),
    (3, 200, 16, 64, 200),
]
# B, S, heads, head dim, valid_len of the tail check: image 1 is NaN, and
# images 0 and 2 must come out bit for bit as with image 1 zero.
TAIL_CASE = (3, 200, 16, 64, 200)
DTYPES = ("bf16", "fp32")


def torch_dtype(name: str):
    import torch

    return {"bf16": torch.bfloat16, "fp32": torch.float32}[name]


def check_kernel(dtype_name: str) -> float:
    """Forward kernel vs plain, and its logsumexp vs ``torch.logsumexp``
    of the plain scores, on the card; returns the largest max |delta| of
    the output at the main path's shape."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_plain)

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = list(KERNEL_CASES)
    if dtype_name == "bf16":  # the timed predict's shape (phase 6)
        cases.append((32, 1370, 16, 64, 1370))
    worst_main = 0.0
    for B, S, H, hd, valid in cases:
        qkv = random_qkv(B, S, H, hd, dtype, gen)
        got = attention_packed(qkv, H, valid)
        want = attention_packed_plain(qkv, H, valid)
        out2, lse = attention_packed(qkv, H, valid, return_lse=True)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        mx, mean = d.max().item(), d.mean().item()
        finite = bool(torch.isfinite(got).all())
        same = torch.equal(got, out2)
        lse_err = lse_vs_logsumexp(qkv, H, valid, lse)
        del got, want, d, out2, lse, qkv
        print(f"kernel {dtype_name} B={B} S={S} H={H} hd={hd} "
              f"valid={valid}: max|d|={mx:.3e} mean|d|={mean:.3e} "
              f"finite={finite}; lse max|d|={lse_err:.3e}, out with lse "
              f"identical={same}")
        expect(finite, "kernel output not finite")
        expect(same, "the lse output changed the forward's output")
        expect(lse_err <= LSE_MAX_ABS, f"lse off: {lse_err}")
        if dtype_name == "bf16":
            expect(mx <= BF16_MAX_ABS and mean <= BF16_MEAN_ABS,
                   f"bf16 kernel off: max {mx}, mean {mean}")
        else:
            expect(mx <= FP32_MAX_ABS, f"fp32 kernel off: max {mx}")
        if S == 1370:
            worst_main = max(worst_main, mx)
    return worst_main


def lse_vs_logsumexp(qkv, H, valid, lse) -> float:
    """max |lse - logsumexp(scaled, masked fp32 scores)| over heads in
    chunks of images (the plain scores are [B, H, S, S] fp32)."""
    import torch

    B, S, width = qkv.shape
    hd = width // 3 // H
    worst = 0.0
    for b in range(B):
        q, k = (qkv[b, :, off:off + H * hd].reshape(S, H, hd)
                .transpose(0, 1).float() for off in (0, H * hd))
        s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        want = torch.logsumexp(s[..., :valid], dim=-1)
        worst = max(worst, (lse[b] - want).abs().max().item())
    return worst


# V-V kernel vs plain, bf16: each row's own key dominates its softmax (the
# self-score |v|^2 hd^-1/2 stands far above the rest), so an output is
# about v itself, up to ~5 in size rather than an average near 0, and one
# flipped bf16 rounding there is an ulp of up to 2^-7 of the value: the
# bar is per element, 2^-7 of the plain output plus 2^-10, mean as above.
# (Read on an NVIDIA H100 80GB HBM3, 700 W: max 1.562e-2 at values in
# [2, 4), mean 2.2e-5.)
VV_BF16_REL, VV_BF16_ABS = 2 ** -7, 2 ** -10

# V-V mode: (B, S, heads, head dim); valid_len is S
VV_CASES = [
    (STAGE1_BATCH, 1370, 16, 64),  # ViT-L/518 at the stage-1 bench's batch
    (2, 1370, 16, 64),             # the features check's batch
    (2, 77, 16, 64),               # ragged: one partial tile
    (2, 257, 16, 64),              # ragged: 4 full tiles + 1 row
    (3, 26, 4, 16),                # tiny-test geometry, head dim 16
    (2, 257, 2, 16),               # head dim 16, ragged
    (2, 128, 16, 64),              # the wgmma kernel's tile edges
    (2, 129, 16, 64),
    (2, 256, 16, 64),
    (3, 200, 16, 64),
]


def check_vv_kernel(dtype_name: str) -> float:
    """The forward kernel's V-V mode vs ``attention_packed_vv_plain`` on
    the card, and vs the standard mode on ``[v, v, v]`` (the same
    arithmetic, bit for bit); returns the largest max |delta| at S 1370."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_vv,
                                                attention_packed_vv_plain)

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst_main = 0.0
    for B, S, H, hd in VV_CASES:
        v = torch.randn(B, S, H * hd, generator=gen, device="cuda").to(dtype)
        got = attention_packed_vv(v, H, S)
        want = attention_packed_vv_plain(v, H, S)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        mx, mean = d.max().item(), d.mean().item()
        over = (d - VV_BF16_REL * want.float().abs()).max().item()
        finite = bool(torch.isfinite(got).all())
        del want, d
        same = None
        if B <= 3:
            same = torch.equal(got, attention_packed(
                torch.cat([v, v, v], dim=-1).contiguous(), H, S))
        print(f"V-V kernel {dtype_name} B={B} S={S} H={H} hd={hd}: "
              f"max|d|={mx:.3e} mean|d|={mean:.3e} finite={finite}"
              + ("" if same is None else
                 f"; equals the standard mode on [v, v, v]: {same}"))
        expect(finite, "V-V kernel output not finite")
        expect(same is not False, "V-V mode differs from the standard mode "
               "on the tripled value section")
        if dtype_name == "bf16":
            expect(over <= VV_BF16_ABS and mean <= BF16_MEAN_ABS,
                   f"bf16 V-V kernel off: max {mx} ({over} over 2^-7 of "
                   f"the output), mean {mean}")
        else:
            expect(mx <= FP32_MAX_ABS, f"fp32 V-V kernel off: max {mx}")
        if S == 1370:
            worst_main = max(worst_main, mx)
        del v, got
    return worst_main


def check_bwd_kernel(dtype_name: str) -> float:
    """Backward kernel vs ``attention_packed_bwd_plain`` on the card,
    dq/dk/dv separately, relative to each gradient's max |value|; returns
    the largest max |delta| at the training step's shape."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_bwd_plain)

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst_main = 0.0
    for B, S, H, hd, valid in KERNEL_CASES:
        qkv = random_qkv(B, S, H, hd, dtype, gen)
        d_out = torch.randn(B, S, H * hd, generator=gen,
                            device="cuda").to(dtype)
        _, lse = attention_packed(qkv, H, valid, return_lse=True)
        got = attention_packed_bwd(qkv, d_out, lse, H, valid)
        again = attention_packed_bwd(qkv, d_out, lse, H, valid)
        want = attention_packed_bwd_plain(qkv, d_out, H, valid)
        torch.cuda.synchronize()
        expect(got.dtype == dtype and got.shape == qkv.shape,
               f"d(qkv) {got.dtype} {tuple(got.shape)}")
        # deterministic: no atomics, every element written once
        expect(torch.equal(got, again), "two backward runs differ")
        del again
        expect(bool(torch.isfinite(got).all()), "d(qkv) not finite")
        parts = []
        dm = H * hd
        for i, name in enumerate(("dq", "dk", "dv")):
            g = got[..., i * dm:(i + 1) * dm].float()
            w = want[..., i * dm:(i + 1) * dm].float()
            scale = w.abs().max().item()
            d = (g - w).abs()
            mx, mean = d.max().item(), d.mean().item()
            parts.append(f"{name} max|d|={mx:.3e} ({mx / scale:.2e} of "
                         f"max {scale:.3e}) mean|d|={mean:.3e}")
            if dtype_name == "bf16":
                expect(mx <= BWD_BF16_MAX_REL * scale
                       and mean <= BWD_BF16_MEAN_REL * scale,
                       f"bf16 backward {name} off: max {mx}, mean {mean}, "
                       f"scale {scale}")
            else:
                expect(mx <= BWD_FP32_MAX_REL * scale,
                       f"fp32 backward {name} off: max {mx}, scale {scale}")
            if S == 1370 and B == TRAIN_BATCH:
                worst_main = max(worst_main, mx)
        if valid < S:  # keys past valid_len get no gradient
            tail = got[:, valid:, dm:].float().abs().max().item()
            expect(tail == 0.0, f"dk/dv past valid_len: {tail}")
        del qkv, d_out, lse, got, want
        print(f"backward {dtype_name} B={B} S={S} H={H} hd={hd} "
              f"valid={valid}: " + "; ".join(parts)
              + "; two runs bit-equal")
    return worst_main


def check_tail_isolation(dtype_name: str) -> None:
    """At TAIL_CASE, image 1 NaN against image 1 zero: a kernel whose tail
    tile of one image read the next image's rows (on [B, H, S, hd], image
    0's last head reading image 1's first) would carry the NaN into images
    0 and 2 (a masked key's P = 0 times NaN is NaN). The forward and its lse, the backward, the V-V
    mode and B4 must give images 0 and 2 bit for bit the same in both
    runs, and finite."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_vv)

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, S, H, hd, valid = TAIL_CASE
    dm = H * hd
    qkv = random_qkv(B, S, H, hd, dtype, gen)
    d_out = torch.randn(B, S, dm, generator=gen, device="cuda").to(dtype)
    runs = []
    for fill in (float("nan"), 0.0):
        x, g = qkv.clone(), d_out.clone()
        x[1], g[1] = fill, fill
        out, lse = attention_packed(x, H, valid, return_lse=True)
        heads = [x[..., i * dm:(i + 1) * dm].reshape(B, S, H, hd)
                 .transpose(1, 2).contiguous() for i in range(3)]
        runs.append((out, lse, attention_packed_bwd(x, g, lse, H, valid),
                     attention_packed_vv(x[..., 2 * dm:].contiguous(), H,
                                         valid),
                     attention_kernel(*heads, valid)))
    torch.cuda.synchronize()
    names = ("forward", "lse", "backward", "V-V", "attention_kernel")
    for name, got, clean in zip(names, *runs):
        same = torch.equal(got[[0, 2]], clean[[0, 2]])
        finite = bool(torch.isfinite(got[[0, 2]]).all())
        print(f"tail {dtype_name} B={B} S={S} hd={hd} {name}: images 0 and 2"
              f" with image 1 NaN equal image 1 zero: {same}, finite: "
              f"{finite}")
        expect(same and finite, f"{name} read across images")


def check_matmul_f32_grad() -> None:
    """bf16 ``matmul_f32`` gradients on the card against fp64 products of
    the same bf16 operands and cotangent, at the trunk's fc shape."""
    import torch

    from aaclip_tpu_torch.models.layers import matmul_f32

    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn(2 * 1370, 1024, generator=gen, device="cuda")
    w = torch.randn(1024, 4096, generator=gen, device="cuda") * 0.03
    a = a.to(torch.bfloat16).requires_grad_()
    w = w.to(torch.bfloat16).requires_grad_()
    g = torch.randn(2 * 1370, 4096, generator=gen, device="cuda")
    y = matmul_f32(a, w)
    expect(y.dtype == torch.float32, f"matmul_f32 output {y.dtype}")
    da, dw = torch.autograd.grad(y, (a, w), g)
    expect(da.dtype == dw.dtype == torch.bfloat16,
           f"gradient dtypes {da.dtype}, {dw.dtype}")
    want_a = g.double() @ w.double().t()
    want_w = a.double().t() @ g.double()
    for name, got, want in (("da", da, want_a), ("dw", dw, want_w)):
        scale = want.abs().max().item()
        err = (got.double() - want).abs().max().item()
        print(f"matmul_f32 bf16 backward {name}: max|d|={err:.3e} "
              f"({err / scale:.2e} of max {scale:.3e})")
        expect(err <= MM_GRAD_MAX_REL * scale, f"matmul_f32 {name} off")


def run_predict(predict, adapter, images, anchors, M):
    import torch

    from aaclip_tpu_torch.ops.attention import attention_packed

    attention_packed.launches = 0
    pix, score = predict(adapter, images, anchors, M)
    torch.cuda.synchronize()
    return pix, score, attention_packed.launches


def phase_predict(vit, adapter, cfg, acfg, anchors, M, card, gen):
    """Phases 4 and 6a: the inference path and its timings; returns
    (forward launches per predict, forward ms, plain ms, SDPA ms).

    ``gen`` draws the images and the timed qkv in the order slice 1's
    script drew them after the anchors, so its readings repeat."""
    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy, get_config
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_plain,
                                                make_attn_fn)
    from aaclip_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix

    heads, img, n_layers = cfg.vision.heads, cfg.vision.image_size, \
        cfg.vision.layers
    bf16 = DtypePolicy.bf16()
    predict_k = make_predict_fn(vit, cfg, acfg, policy=bf16,
                                uint8_inputs=True)
    predict_p = make_predict_fn(
        vit, cfg, acfg, policy=bf16, uint8_inputs=True,
        attn_fn=make_attn_fn(heads, bf16, attention=attention_packed_plain))
    u8 = torch.randint(0, 256, (8, 3, img, img), generator=gen,
                       device="cuda", dtype=torch.uint8)
    pix_k, score_k, main_launches = run_predict(predict_k, adapter, u8,
                                                anchors, M)
    pix_p, score_p, plain_launches = run_predict(predict_p, adapter, u8,
                                                 anchors, M)
    expect(pix_k.shape == (8, img, img) and score_k.shape == (8,),
           f"shapes {pix_k.shape}, {score_k.shape}")
    expect(bool(torch.isfinite(pix_k).all() and torch.isfinite(score_k).all()),
           "bf16 predict output not finite")
    expect(main_launches == n_layers, f"{main_launches} kernel launches")
    expect(plain_launches == 0, f"plain path launched {plain_launches}")
    span = (pix_p.max() - pix_p.min()).item()
    dpix = (pix_k - pix_p).abs().max().item()
    dscore = (score_k - score_p).abs().max().item()
    print(f"predict bf16 B=8: launches={main_launches} per call; map span "
          f"{span:.4f}, max|d map| {dpix:.3e} ({dpix / span:.3e} of span), "
          f"max|d score| {dscore:.3e}")
    expect(dpix <= PIX_SPAN_FRAC_BF16 * span, f"map off: {dpix} of {span}")
    expect(dscore <= SCORE_ATOL_BF16, f"scores off: {dscore}")

    fp32 = DtypePolicy.fp32()
    predict_k32 = make_predict_fn(vit, cfg, acfg, policy=fp32)
    predict_p32 = make_predict_fn(
        vit, cfg, acfg, policy=fp32,
        attn_fn=make_attn_fn(heads, fp32, attention=attention_packed_plain))
    # bf16's own deviation from fp32 on the same weights and images, the
    # scale against which the bf16 kernel-vs-plain bar above is read
    mean = torch.from_numpy(CLIP_MEAN).cuda()[:, None, None]
    std = torch.from_numpy(CLIP_STD).cuda()[:, None, None]
    pix_32, score_32, _ = run_predict(predict_k32, adapter,
                                      (u8.float() / 255.0 - mean) / std,
                                      anchors, M)
    dpix32 = (pix_k - pix_32).abs().max().item()
    span32 = (pix_32.max() - pix_32.min()).item()
    print(f"predict bf16 vs fp32 B=8 (kernel both, same weights and images):"
          f" max|d map| {dpix32:.3e} ({dpix32 / span32:.3e} of the fp32 "
          f"span {span32:.4f}), max|d score| "
          f"{(score_k - score_32).abs().max().item():.3e}")
    del pix_32, score_32

    f32 = torch.randn(2, 3, img, img, generator=gen, device="cuda")
    pix_k, score_k, launches32 = run_predict(predict_k32, adapter, f32,
                                             anchors, M)
    pix_p, score_p, _ = run_predict(predict_p32, adapter, f32, anchors, M)
    expect(launches32 == n_layers, f"{launches32} fp32 kernel launches")
    print(f"predict fp32 B=2: launches={launches32} per call; max|d map| "
          f"{(pix_k - pix_p).abs().max().item():.3e}, max|d score| "
          f"{(score_k - score_p).abs().max().item():.3e}")
    torch.testing.assert_close(pix_k, pix_p, atol=PIX_ATOL_FP32,
                               rtol=PIX_RTOL_FP32)
    torch.testing.assert_close(score_k, score_p, atol=SCORE_ATOL_FP32,
                               rtol=0)
    del predict_k32, predict_p32, pix_k, pix_p

    tiny = get_config("tiny-test")
    tacfg = tiny_acfg()
    outs = []
    for dev in ("cuda", "cpu"):
        tvit = init_vision_params(tiny, seed=0, device="cpu").to(dev)
        tad = init_image_adapter(tiny, tacfg, seed=1, device="cpu").to(dev)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((3, 3, 70, 70)).astype(np.float32)
        a = rng.standard_normal((tiny.embed_dim, 2)).astype(np.float32)
        a /= np.linalg.norm(a, axis=0, keepdims=True)
        tM = fused_postproc_matrix(tiny.vision.grid, 70, "Industrial")
        tp = make_predict_fn(tvit, tiny, tacfg, policy=fp32, device=dev)
        outs.append([t.cpu() for t in tp(tad, torch.from_numpy(x),
                                         torch.from_numpy(a),
                                         torch.from_numpy(tM))])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=TINY_ATOL, rtol=TINY_RTOL)
    print("predict tiny-test fp32: card (kernel, hd 16) matches the CPU")

    # timings at the predict's attention shape
    B, S, hd = 32, cfg.vision.seq_len, cfg.vision.head_dim
    qkv = random_qkv(B, S, heads, hd, torch.bfloat16, gen)
    fwd = functools.partial(attention_packed, qkv, heads, S)
    ms_kernel = cuda_ms(fwd, 20)
    per_call = kernels_per_call(fwd, "attention_packed", {"attn_fwd_wgmma": 1},
                                "attention_packed")
    ms_plain = cuda_ms(lambda: attention_packed_plain(qkv, heads, S), 5)
    q, k, v = qkv.view(B, S, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    ms_sdpa = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 20)
    flops = 4 * B * heads * S * S * hd
    bound_ms, bound_by = bound(flops, B * S * (3 + 1) * heads * hd *
                               qkv.element_size())
    for name, ms in (("kernel", ms_kernel), ("plain", ms_plain),
                     ("sdpa", ms_sdpa)):
        print(f"time attention {name} [{B},{S},{3 * heads * hd}] bf16: "
              f"{ms:.4f} ms/launch ({flops / ms / 1e9:.1f} TFLOP/s; bound "
              f"{bound_ms:.4f} ms by {bound_by}) on {card}")
    del qkv, q, k, v

    u8 = torch.randint(0, 256, (32, 3, img, img), generator=gen,
                       device="cuda", dtype=torch.uint8)
    ms_pred = cuda_ms(lambda: predict_k(adapter, u8, anchors, M), 5)
    ms_pred_p = cuda_ms(lambda: predict_p(adapter, u8, anchors, M), 3)
    for name, ms in (("kernel", ms_pred), ("plain", ms_pred_p)):
        print(f"time predict bf16 B=32 ViT-L/518 ({name} attention): "
              f"{ms:.2f} ms/call, {32 / ms * 1e3:.2f} maps/s on {card}")
    return (main_launches, per_call, ms_kernel, ms_plain, ms_sdpa, bound_ms,
            bound_by)


def tiny_acfg():
    from aaclip_tpu_torch.core.config import AdapterConfig

    return AdapterConfig(levels=(1, 2), image_adapt_until=1)


def train_batch(B, img, gen):
    """Random float images, mask > 0.9, random labels and classes, all
    valid: the JAX package's stage-2 bench batch, made on the card."""
    import torch

    images = torch.randn(B, 3, img, img, generator=gen, device="cuda")
    mask = (torch.rand(B, img, img, generator=gen, device="cuda")
            > 0.9).float()
    label = torch.randint(0, 2, (B,), generator=gen, device="cuda")
    cidx = torch.randint(0, 2, (B,), generator=gen, device="cuda")
    return images, mask, label, cidx, torch.ones(B, device="cuda")


def unit_table(embed_dim, gen, device="cuda"):
    """A random 2-class table of unit anchors [2, D, 2]."""
    import torch

    t = torch.randn(2, embed_dim, 2, generator=gen, device=device)
    return t / t.norm(dim=1, keepdim=True)


def train_step_once(vit, cfg, acfg, adapter, batch, table, *, policy,
                    attn_fn=None, remat, device=None):
    """One stage-2 step from a copy of ``adapter``; returns (loss, {name:
    grad}, forward launches, backward launches, the updated copy)."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd)
    from aaclip_tpu_torch.train.optim import make_image_optimizer
    from aaclip_tpu_torch.train.steps import make_stage2_step

    ad = copy.deepcopy(adapter)
    opt, sched = make_image_optimizer(ad.parameters())
    step = make_stage2_step(vit, cfg, acfg, (opt, sched), table,
                            policy=policy, attn_fn=attn_fn, remat=remat,
                            device=device)
    attention_packed.launches = attention_packed_bwd.launches = 0
    loss = step(ad, *batch)
    if loss.is_cuda:
        torch.cuda.synchronize()
    fwd, bwd = attention_packed.launches, attention_packed_bwd.launches
    grads = {n: p.grad.detach().clone() for n, p in ad.named_parameters()}
    return loss.item(), grads, fwd, bwd, (ad, opt, sched, step)


def phase_train(vit, adapter, cfg, acfg, card):
    """Phases 5 and 6b: the stage-2 step; returns the forward and backward
    launches per step without remat."""
    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy, get_config
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.ops.attention import (attention_packed_diff_plain,
                                                make_attn_fn)

    n_layers, img = cfg.vision.layers, cfg.vision.image_size
    gen = torch.Generator(device="cuda").manual_seed(5)
    table = unit_table(cfg.embed_dim, gen)
    bf16 = DtypePolicy.bf16()
    batch2 = train_batch(2, img, gen)
    loss_k, g_k, fwd_r, bwd_r, _ = train_step_once(
        vit, cfg, acfg, adapter, batch2, table, policy=bf16, remat=True)
    plain = make_attn_fn(cfg.vision.heads, bf16,
                         attention=attention_packed_diff_plain)
    loss_p, g_p, fwd_p, bwd_p, _ = train_step_once(
        vit, cfg, acfg, adapter, batch2, table, policy=bf16, attn_fn=plain,
        remat=True)
    print(f"train bf16 B=2 remat: kernel launches forward {fwd_r}, backward "
          f"{bwd_r}; plain step launches {fwd_p}, {bwd_p}; loss kernel "
          f"{loss_k:.6f} plain {loss_p:.6f} (rel "
          f"{abs(loss_k - loss_p) / abs(loss_p):.3e})")
    expect(fwd_r == 2 * n_layers - 1 and bwd_r == n_layers - 1,
           f"remat step launches {fwd_r}, {bwd_r}")
    expect(fwd_p == bwd_p == 0, "the plain step launched a kernel")
    expect(np.isfinite(loss_k), "kernel step loss not finite")
    expect(abs(loss_k - loss_p) <= STEP_LOSS_RTOL * abs(loss_p),
           f"step loss off: {loss_k} vs {loss_p}")
    worst_cos, worst_norm = 1.0, 0.0
    for name, gk in g_k.items():
        gp = g_p[name]
        cos = torch.nn.functional.cosine_similarity(
            gk.flatten().double(), gp.flatten().double(), dim=0).item()
        norm = abs(gk.norm().item() / gp.norm().item() - 1.0)
        worst_cos, worst_norm = min(worst_cos, cos), max(worst_norm, norm)
        expect(cos >= STEP_GRAD_COS and norm <= STEP_GRAD_NORM_RTOL,
               f"gradient of {name} off: cosine {cos}, norm {norm}")
    print(f"train bf16 B=2 kernel vs plain gradients over {len(g_k)} "
          f"adapter leaves: min cosine {worst_cos:.6f}, max |norm ratio - 1| "
          f"{worst_norm:.3e}")
    del g_k, g_p, batch2

    batch8 = train_batch(TRAIN_BATCH, img, gen)
    torch.cuda.reset_peak_memory_stats()
    loss0, _, fwd, bwd, (ad, opt, sched, step) = train_step_once(
        vit, cfg, acfg, adapter, batch8, table, policy=bf16, remat=False)
    losses = [loss0] + [step(ad, *batch8).item() for _ in range(4)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train bf16 B={TRAIN_BATCH} no remat: launches forward {fwd}, "
          f"backward {bwd} per step; losses over 5 steps "
          + ", ".join(f"{l:.6f}" for l in losses)
          + f"; peak device memory {peak:.2f} GiB")
    expect(fwd == n_layers and bwd == n_layers - 1,
           f"step launches {fwd}, {bwd}")
    expect(all(np.isfinite(losses)), "a training loss is not finite")
    ms_step = cuda_ms(lambda: step(ad, *batch8), 5, warmup=1)
    print(f"time train step bf16 B={TRAIN_BATCH} ViT-L/518 no remat: "
          f"{ms_step:.2f} ms/step, {TRAIN_BATCH / ms_step * 1e3:.2f} "
          f"images/s on {card}")
    del ad, opt, sched, step, batch8

    tiny = get_config("tiny-test")
    tacfg = tiny_acfg()
    runs = []
    for dev in ("cuda", "cpu"):
        tvit = init_vision_params(tiny, seed=0, device="cpu").to(dev)
        tad = init_image_adapter(tiny, tacfg, seed=1, device="cpu").to(dev)
        rng = np.random.default_rng(6)
        batch = (torch.from_numpy(rng.standard_normal((4, 3, 70, 70))
                                  .astype(np.float32)),
                 torch.from_numpy((rng.random((4, 70, 70)) > 0.8)
                                  .astype(np.float32)),
                 torch.tensor([0, 1, 0, 1]), torch.tensor([0, 1, 1, 0]),
                 torch.tensor([1.0, 1.0, 1.0, 0.0]))
        ttable = unit_table(tiny.embed_dim, torch.Generator().manual_seed(7),
                            device="cpu")
        loss, grads, *_ = train_step_once(
            tvit, tiny, tacfg, tad, batch, ttable,
            policy=DtypePolicy.fp32(), remat=False, device=dev)
        runs.append((loss, {n: g.cpu() for n, g in grads.items()}))
    (loss_c, g_c), (loss_h, g_h) = runs
    expect(abs(loss_c - loss_h) <= TINY_STEP_LOSS_RTOL * abs(loss_h),
           f"tiny step loss card {loss_c} vs CPU {loss_h}")
    for name, gc in g_c.items():
        err = (gc - g_h[name]).abs().max().item()
        expect(err <= TINY_STEP_GRAD_REL * g_h[name].abs().max().item(),
               f"tiny step gradient {name} off by {err}")
    print(f"train tiny-test fp32: card (kernels, hd 16) matches the CPU "
          f"(loss {loss_c:.6f} vs {loss_h:.6f})")
    return fwd, bwd


def time_bwd(cfg, card):
    """Phase 6c: the backward kernel, its plain version and SDPA's
    backward at the training step's attention shape."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_bwd_plain)

    B, S, H, hd = TRAIN_BATCH, cfg.vision.seq_len, cfg.vision.heads, \
        cfg.vision.head_dim
    gen = torch.Generator(device="cuda").manual_seed(8)
    qkv = random_qkv(B, S, H, hd, torch.bfloat16, gen)
    d_out = torch.randn(B, S, H * hd, generator=gen,
                        device="cuda").to(torch.bfloat16)
    _, lse = attention_packed(qkv, H, S, return_lse=True)
    bwd = functools.partial(attention_packed_bwd, qkv, d_out, lse, H, S)
    ms_kernel = cuda_ms(bwd, 10)
    per_call = kernels_per_call(
        bwd, "attention_packed_bwd",
        {"attn_bwd_dq_wgmma": 1, "attn_bwd_dkdv_wgmma": 1},
        "attention_packed_bwd")
    ms_plain = cuda_ms(lambda: attention_packed_bwd_plain(qkv, d_out, H, S),
                       3)
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(B, S, 3, H, hd).permute(2, 0, 3, 1, 4).unbind(0))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    g = d_out.view(B, S, H, hd).transpose(1, 2)
    ms_sdpa = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                  retain_graph=True), 10)
    # the TPU kernel's five S^2*hd products; each input read once, each
    # output written once
    flops = 10 * B * H * S * S * hd
    own_flops = 18 * B * H * S * S * hd  # the kernel pair's nine products
    nbytes = (2 * qkv.numel() + d_out.numel()) * qkv.element_size() + \
        lse.numel() * 4
    bound_ms, bound_by = bound(flops, nbytes)
    for name, ms in (("kernel", ms_kernel), ("plain", ms_plain),
                     ("sdpa backward", ms_sdpa)):
        own = (f", {own_flops / ms / 1e9:.1f} TFLOP/s of its own nine "
               f"products" if name == "kernel" else "")
        print(f"time attention backward {name} [{B},{S},{3 * H * hd}] bf16: "
              f"{ms:.4f} ms/call ({flops / ms / 1e9:.1f} TFLOP/s of the "
              f"TPU kernel's five products{own}; bound {bound_ms:.4f} ms by "
              f"{bound_by}) on {card}")
    return per_call, ms_kernel, ms_plain, ms_sdpa, bound_ms, bound_by


def stage1_batch(B, img, gen):
    """The JAX package's stage-1 bench batch made on the card: normal
    images, mask > 0.9, classes among VisA's 12, all valid."""
    import torch

    images = torch.randn(B, 3, img, img, generator=gen, device="cuda")
    mask = (torch.rand(B, img, img, generator=gen, device="cuda")
            > 0.9).float()
    cidx = torch.randint(0, 12, (B,), generator=gen, device="cuda")
    return images, mask, cidx, torch.ones(B, device="cuda")


def counts():
    """(standard forward, V-V, backward) launch counts."""
    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_vv)

    return (attention_packed.launches, attention_packed_vv.launches,
            attention_packed_bwd.launches)


def zero_counts() -> None:
    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_bwd,
                                                attention_packed_vv)

    attention_packed.launches = attention_packed_vv.launches = 0
    attention_packed_bwd.launches = 0


def stage1_step_once(text, cfg, acfg, adapter, tokens, feats, batch, *,
                     policy, device="cuda"):
    """One stage-1 step from a copy of ``adapter``; returns (loss, {name:
    grad}, (the copy, its step))."""
    import torch

    from aaclip_tpu_torch.train.optim import make_text_optimizer
    from aaclip_tpu_torch.train.steps import make_stage1_step

    ad = copy.deepcopy(adapter)
    step = make_stage1_step(text, cfg, acfg,
                            make_text_optimizer(ad.parameters()), tokens,
                            policy=policy, device=device)
    _, mask, cidx, valid = batch
    loss = step(ad, feats, mask, cidx, valid)
    if loss.is_cuda:
        torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in ad.named_parameters()}
    return loss.item(), grads, (ad, step)


def phase_stage1(vit, cfg, card):
    """Phase 7: the stage-1 path and its timings; returns (V-V launches
    per spatial features call, V-V kernel ms, plain ms, SDPA ms, bound ms,
    bound_by)."""
    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (init_text_adapter,
                                              init_text_params,
                                              init_vision_params)
    from aaclip_tpu_torch.ops.attention import (attention_packed_plain,
                                                attention_packed_vv,
                                                attention_packed_vv_plain,
                                                make_attn_fn)
    from aaclip_tpu_torch.text.anchors import dataset_prompt_tokens
    from aaclip_tpu_torch.train.steps import stage1_features_fn

    heads, img, n_layers = cfg.vision.heads, cfg.vision.image_size, \
        cfg.vision.layers
    vv_start = n_layers - (STAGE1_SURGERY_UNTIL - 1)
    bf16 = DtypePolicy.bf16()
    acfg = AdapterConfig()
    text = init_text_params(cfg, seed=3)
    adapter = init_text_adapter(cfg, acfg, seed=4)
    tokens = dataset_prompt_tokens("VisA")                  # [12, 16, 77]
    gen = torch.Generator(device="cuda").manual_seed(10)

    # (a) spatial features, kernels vs plain, batch 2
    feats_k_fn = stage1_features_fn(vit, cfg, policy=bf16, vv_mode="spatial")
    feats_p_fn = stage1_features_fn(
        vit, cfg, policy=bf16, vv_mode="spatial",
        attn_fn=make_attn_fn(heads, bf16, attention=attention_packed_plain),
        vv_attn_fn=make_attn_fn(heads, bf16, vv=True,
                                attention=attention_packed_vv_plain))
    batch2 = stage1_batch(2, img, gen)
    zero_counts()
    feats_k = feats_k_fn(batch2[0])
    torch.cuda.synchronize()
    main_std, main_vv, main_bwd = counts()
    zero_counts()
    feats_p = feats_p_fn(batch2[0])
    torch.cuda.synchronize()
    plain_counts = counts()
    n_patches = cfg.vision.num_patches
    expect(feats_k.shape == (2, n_patches, cfg.embed_dim)
           and feats_k.dtype == torch.float32, f"features {feats_k.shape}")
    expect(bool(torch.isfinite(feats_k).all()), "features not finite")
    expect((main_std, main_vv, main_bwd)
           == (vv_start + (n_layers - vv_start), n_layers - vv_start, 0),
           f"spatial features launches {main_std}, {main_vv}, {main_bwd}")
    expect(plain_counts == (0, 0, 0), f"plain features launched "
           f"{plain_counts}")
    dmax = (feats_k - feats_p).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(feats_k.double(),
                                                feats_p.double(), dim=-1)
    print(f"stage-1 spatial features bf16 B=2: launches {main_std} standard"
          f" + {main_vv} V-V per call (plain: {plain_counts}); kernel vs "
          f"plain max|d| {dmax:.3e}, least per-token cosine "
          f"{cos.min().item():.8f}, mean {cos.mean().item():.8f}")
    expect(dmax <= S1_FEAT_MAX_ABS and cos.min().item() >= S1_FEAT_COS,
           f"spatial features off: max {dmax}, cosine {cos.min().item()}")

    # (d) one step from kernel features vs one from plain features
    loss_k, g_k, _ = stage1_step_once(text, cfg, acfg, adapter, tokens,
                                      feats_k, batch2, policy=bf16)
    loss_p, g_p, _ = stage1_step_once(text, cfg, acfg, adapter, tokens,
                                      feats_p, batch2, policy=bf16)
    print(f"stage-1 step bf16 B=2 from kernel vs plain features: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{abs(loss_k - loss_p) / abs(loss_p):.3e})")
    expect(np.isfinite(loss_k), "stage-1 loss not finite")
    expect(abs(loss_k - loss_p) <= S1_STEP_LOSS_RTOL * abs(loss_p),
           f"stage-1 step loss off: {loss_k} vs {loss_p}")
    for name, gk in g_k.items():
        gp = g_p[name]
        c = torch.nn.functional.cosine_similarity(
            gk.flatten().double(), gp.flatten().double(), dim=0).item()
        norm = abs(gk.norm().item() / gp.norm().item() - 1.0)
        print(f"  gradient {name}: cosine {c:.8f}, |norm ratio - 1| "
              f"{norm:.3e}")
        expect(c >= S1_STEP_GRAD_COS and norm <= S1_STEP_GRAD_NORM_RTOL,
               f"stage-1 gradient of {name} off: cosine {c}, norm {norm}")
    del feats_k, feats_p, feats_p_fn, g_k, g_p

    # (b) batch-mode features at batch 16
    feats_b_fn = stage1_features_fn(vit, cfg, policy=bf16)
    batch16 = stage1_batch(STAGE1_BATCH, img, gen)
    zero_counts()
    feats_b = feats_b_fn(batch16[0], batch16[3])
    torch.cuda.synchronize()
    b_counts = counts()
    print(f"stage-1 batch-mode features bf16 B={STAGE1_BATCH}: launches "
          f"{b_counts[0]} standard + {b_counts[1]} V-V per call; finite "
          f"{bool(torch.isfinite(feats_b).all())}")
    expect(b_counts == (n_layers, 0, 0), f"batch-mode launches {b_counts}")
    expect(bool(torch.isfinite(feats_b).all()), "batch features not finite")
    del feats_b

    # (c) five iterations at batch 16 from spatial features
    torch.cuda.reset_peak_memory_stats()
    loss0, _, (ad, step) = stage1_step_once(
        text, cfg, acfg, adapter, tokens, feats_k_fn(batch16[0]), batch16,
        policy=bf16)
    losses = [loss0] + [step(ad, feats_k_fn(batch16[0]), *batch16[1:]).item()
                        for _ in range(4)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"stage-1 bf16 B={STAGE1_BATCH} spatial: losses over 5 iterations "
          + ", ".join(f"{l:.6f}" for l in losses)
          + f"; peak device memory {peak:.2f} GiB")
    expect(all(np.isfinite(losses)), "a stage-1 loss is not finite")

    # (e) tiny-test fp32, card vs CPU
    tiny = get_config("tiny-test")
    tacfg = AdapterConfig(levels=(1, 2), image_adapt_until=1,
                          text_adapt_until=1)
    fp32 = DtypePolicy.fp32()
    runs = []
    for dev in ("cuda", "cpu"):
        tvit = init_vision_params(tiny, seed=0, device="cpu").to(dev)
        ttext = init_text_params(tiny, seed=0, device="cpu").to(dev)
        tad = init_text_adapter(tiny, tacfg, seed=1, device="cpu").to(dev)
        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.standard_normal((4, 3, 70, 70))
                             .astype(np.float32)).to(dev)
        tb = (x, torch.from_numpy((rng.random((4, 70, 70)) > 0.8)
                                  .astype(np.float32)).to(dev),
              torch.tensor([0, 1, 1, 0], device=dev),
              torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev))
        f = stage1_features_fn(tvit, tiny, surgery_until_layer=2,
                               policy=fp32, vv_mode="spatial",
                               device=dev)(x)
        loss, grads, _ = stage1_step_once(
            ttext, tiny, tacfg, tad, dataset_prompt_tokens(
                "MVTec", ["bottle", "cable"]), f, tb, policy=fp32,
            device=dev)
        runs.append((f.cpu(), loss, {n: g.cpu() for n, g in grads.items()}))
    (f_c, loss_c, g_c), (f_h, loss_h, g_h) = runs
    torch.testing.assert_close(f_c, f_h, atol=TINY_ATOL, rtol=TINY_RTOL)
    expect(abs(loss_c - loss_h) <= TINY_STEP_LOSS_RTOL * abs(loss_h),
           f"tiny stage-1 loss card {loss_c} vs CPU {loss_h}")
    for name, gc in g_c.items():
        err = (gc - g_h[name]).abs().max().item()
        expect(err <= TINY_STEP_GRAD_REL * g_h[name].abs().max().item(),
               f"tiny stage-1 gradient {name} off by {err}")
    print(f"stage-1 tiny-test fp32: card (kernels, hd 16) matches the CPU "
          f"(features, loss {loss_c:.6f} vs {loss_h:.6f}, gradients)")

    # timings: the V-V kernel at the bench's shape
    B, S, hd = STAGE1_BATCH, cfg.vision.seq_len, cfg.vision.head_dim
    v = torch.randn(B, S, heads * hd, generator=gen,
                    device="cuda").to(torch.bfloat16)
    vv = functools.partial(attention_packed_vv, v, heads, S)
    ms_kernel = cuda_ms(vv, 20)
    per_call = kernels_per_call(vv, "attention_packed", {"attn_fwd_wgmma": 1},
                                "attention_packed_vv")
    ms_plain = cuda_ms(lambda: attention_packed_vv_plain(v, heads, S), 3)
    q = v.view(B, S, heads, hd).transpose(1, 2)
    ms_sdpa = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, q, q), 20)
    flops = 4 * B * heads * S * S * hd
    bound_ms, bound_by = bound(flops, 2 * v.numel() * v.element_size())
    for name, ms in (("kernel", ms_kernel), ("plain", ms_plain),
                     ("sdpa", ms_sdpa)):
        print(f"time V-V attention {name} [{B},{S},{heads * hd}] bf16: "
              f"{ms:.4f} ms/launch ({flops / ms / 1e9:.1f} TFLOP/s; bound "
              f"{bound_ms:.4f} ms by {bound_by}) on {card}")
    del v, q

    # timings: whole stage-1 iterations at batch 16
    for mode, fn in (("spatial", feats_k_fn), ("batch", feats_b_fn)):
        def iteration():
            return step(ad, fn(batch16[0], batch16[3]), *batch16[1:])

        ms = cuda_ms(iteration, 3, warmup=1)
        print(f"time stage-1 iteration bf16 B={STAGE1_BATCH} ViT-L/518 "
              f"(features + step, vv {mode}): {ms:.2f} ms, "
              f"{STAGE1_BATCH / ms * 1e3:.2f} images/s on {card}")
    return main_vv, per_call, ms_kernel, ms_plain, ms_sdpa, bound_ms, bound_by


def fused_inputs(B, S, D, F, dtype, gen):
    """x [B, S, D] ~ N(0, 1), LayerNorm affine near (1, 0), w [F, D] at
    CLIP's fc scale, biases ~ 0.02, on the card in ``dtype`` (the vectors
    too, as the predictor casts a block's leaves)."""
    import torch

    def n(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * s).to(
            dtype)

    return dict(x=n(B, S, D), g=(1 + torch.randn(D, generator=gen,
                                                 device="cuda") * 0.1
                                 ).to(dtype),
                b=n(D, s=0.1), w=n(F, D, s=D ** -0.5), bias=n(F, s=0.02),
                w2=n(D, F, s=F ** -0.5), bias2=n(D, s=0.02))


def fused_err(got, want, dtype_name: str, what: str) -> float:
    """Max |got - want| after checking it against the phase-8 bars."""
    import torch

    expect(got.shape == want.shape and got.dtype == want.dtype,
           f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
           f"{tuple(want.shape)}")
    expect(bool(torch.isfinite(got).all()), f"{what}: not finite")
    g, w = got.float(), want.float()
    d = (g - w).abs()
    mx, mean = d.max().item(), d.mean().item()
    top = w.abs().max().item()
    if dtype_name == "bf16":
        over = (d - FUSED_BF16_REL * w.abs()).max().item()
        ok = (over <= FUSED_BF16_OF_MAX * top
              and mean <= FUSED_BF16_MEAN * w.abs().mean().item())
    else:
        ok = mx <= FUSED_FP32_OF_MAX * top
    print(f"  {what}: max|d|={mx:.3e} mean|d|={mean:.3e} (max|plain| "
          f"{top:.3f})")
    expect(ok, f"{what} off: max {mx}, mean {mean}, max|plain| {top}")
    return mx


# (B, S, D, hidden F): the predict's batch-32 rows, ragged rows, the bf16
# GEMM's 128-row tile edges (one tile, one row over, one short of two),
# ViT-B-16's width at 224 px, and width 128 (N 384 and 128 take the
# 128-column tile)
FUSED_CASES = [(32, 1370, 1024, 4096), (3, 37, 1024, 4096),
               (1, 128, 1024, 4096), (1, 129, 1024, 4096),
               (1, 255, 1024, 4096), (2, 197, 768, 3072), (2, 21, 128, 512)]
# the NaN-row check: x [B, S, D], hidden F, and the poisoned row
NAN_ROW_CASE = (3, 200, 1024, 4096, 300)


def twice(fn, what: str):
    """``fn()`` run twice; the two outputs must be equal bit for bit."""
    import torch

    first, second = fn(), fn()
    expect(torch.equal(first, second), f"{what}: two runs differ")
    return first


def fused_calls(FB, t, y, policy, acts, plain=False):
    """{name: call} of B5 (to 3D columns, the QKV projection, and to D, the
    V-V value third), B6 and B7 under each activation of ``acts``, on the
    inputs of ``fused_inputs`` and the out-projection input y: FB's
    wrappers, or with ``plain`` their plain versions."""
    def op(name):
        return getattr(FB, f"{name}_plain" if plain else name)

    x, g, b = t["x"], t["g"], t["b"]
    D = x.shape[-1]
    wo, bo = t["w"][:D].contiguous(), t["bias"][:D].contiguous()
    calls = {f"ln_linear F={n}": (lambda n=n: op("ln_linear")(
        x, g, b, t["w"][:n], t["bias"][:n], policy)) for n in (3 * D, D)}
    calls["linear_residual"] = lambda: op("linear_residual")(x, y, wo, bo,
                                                             policy)
    for act in acts:
        calls[f"mlp_fused {act.__name__}"] = lambda act=act: op("mlp_fused")(
            x, g, b, t["w"], t["bias"], t["w2"], t["bias2"], act, policy)
    return calls


def check_fused_kernels(dtype_name: str) -> dict:
    """B5-B7 against their plain versions on the card, each kernel run
    twice bit for bit; returns the largest max |d| of each at the batch-32
    shape."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.ops import fused_block as FB

    dtype = torch_dtype(dtype_name)
    policy = DtypePolicy(dtype, dtype_name == "bf16")
    gen = torch.Generator(device="cuda").manual_seed(20)
    worst = {"ln_linear": 0.0, "linear_residual": 0.0, "mlp_fused": 0.0}
    for B, S, D, F in FUSED_CASES:
        t = fused_inputs(B, S, D, F, dtype, gen)
        y = torch.randn(B, S, D, generator=gen, device="cuda").to(dtype)
        print(f"fused kernels {dtype_name} x [{B},{S},{D}], hidden {F}:")
        acts = (L.gelu, L.gelu_tanh, L.quick_gelu)
        if not FB._mlp_widths_ok(dtype, D, F):
            print(f"  mlp_fused: no {dtype_name} kernel at width {D} (the "
                  f"fp32 MLP is instantiated at {FB.KERNEL_MLP_WIDTHS})")
            expect(dtype_name == "fp32", f"no bf16 MLP at width {D}")
            acts = ()
        plain = fused_calls(FB, t, y, policy, acts, plain=True)
        errs = {name: fused_err(twice(fn, name), plain[name](), dtype_name,
                                name)
                for name, fn in fused_calls(FB, t, y, policy, acts).items()}
        torch.cuda.synchronize()
        if B == 32:
            for name in worst:
                worst[name] = max(v for k, v in errs.items()
                                  if k.startswith(name))
        del t, y
    return worst


def check_fused_nan_row(dtype_name: str) -> None:
    """One row of x (and of the out-projection's input) NaN: every other
    row of each B5-B7 output is bit for bit the output with that row 0."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.ops import fused_block as FB

    B, S, D, F, row = NAN_ROW_CASE
    dtype = torch_dtype(dtype_name)
    policy = DtypePolicy(dtype, dtype_name == "bf16")
    gen = torch.Generator(device="cuda").manual_seed(26)
    t = fused_inputs(B, S, D, F, dtype, gen)
    y = torch.randn(B, S, D, generator=gen, device="cuda").to(dtype)
    outs = []
    for fill in (float("nan"), 0.0):
        t["x"].view(-1, D)[row] = fill
        y.view(-1, D)[row] = fill
        calls = fused_calls(FB, t, y, policy, (L.gelu_tanh,))
        outs.append({k: fn().view(B * S, -1) for k, fn in calls.items()})
    torch.cuda.synchronize()
    keep = torch.arange(B * S, device="cuda") != row
    for name, poisoned in outs[0].items():
        clean = outs[1][name]
        expect(bool(torch.isnan(poisoned[row]).all()),
               f"{name}: the NaN row did not come out NaN")
        expect(torch.equal(poisoned[keep], clean[keep]),
               f"{name}: the NaN row moved other rows")
    print(f"fused kernels {dtype_name}, row {row} of x [{B},{S},{D}] NaN: "
          f"every other row of {', '.join(outs[0])} equals the output with "
          f"the row 0, bit for bit")


# B4: (B, H, S, head dim, valid_len)
BHSD_CASES = [(32, 16, 1370, 64, 1370), (2, 16, 257, 64, 200),
              (3, 4, 26, 16, 26), (2, 2, 77, 16, 50),
              # the wgmma kernel's tile edges
              (2, 16, 128, 64, 128), (2, 16, 129, 64, 129),
              (2, 16, 256, 64, 256), (2, 16, 200, 64, 128),
              (3, 16, 200, 64, 200)]


def check_attention_kernel(dtype_name: str) -> float:
    """B4 against its plain version and bit for bit against
    ``attention_packed`` on the same values packed [B, S, 3D]; returns the
    max |d| at the batch-32 shape."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_kernel_plain,
                                                attention_packed)

    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(21)
    worst = 0.0
    for B, H, S, hd, valid in BHSD_CASES:
        q, k, v = (torch.randn(B, H, S, hd, generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        got = attention_kernel(q, k, v, valid)
        want = attention_kernel_plain(q, k, v, valid)
        packed = torch.cat([t.transpose(1, 2).reshape(B, S, H * hd)
                            for t in (q, k, v)], dim=-1).contiguous()
        same = torch.equal(got.transpose(1, 2).reshape(B, S, H * hd),
                           attention_packed(packed, H, valid))
        torch.cuda.synchronize()
        expect(got.shape == q.shape and got.dtype == dtype,
               f"attention_kernel {got.dtype} {tuple(got.shape)}")
        d = (got.float() - want.float()).abs()
        mx, mean = d.max().item(), d.mean().item()
        finite = bool(torch.isfinite(got).all())
        del want, d, packed, q, k, v, got
        print(f"attention_kernel {dtype_name} [{B},{H},{S},{hd}] valid="
              f"{valid}: max|d|={mx:.3e} mean|d|={mean:.3e} finite={finite};"
              f" equals attention_packed on the packed values: {same}")
        expect(finite, "attention_kernel output not finite")
        expect(same, "attention_kernel differs from attention_packed")
        if dtype_name == "bf16":
            expect(mx <= BF16_MAX_ABS and mean <= BF16_MEAN_ABS,
                   f"bf16 attention_kernel off: max {mx}, mean {mean}")
        else:
            expect(mx <= FP32_MAX_ABS, f"fp32 attention_kernel off: {mx}")
        if B == 32:
            worst = max(worst, mx)
    return worst


FUSED_COUNTED = ("ln_linear", "attention_packed", "attention_packed_vv",
                 "linear_residual", "mlp_fused", "attention_kernel")


def fused_counts():
    """The launch counts of FUSED_COUNTED, in its order."""
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_packed,
                                                attention_packed_vv)

    return (FB.ln_linear.launches, attention_packed.launches,
            attention_packed_vv.launches, FB.linear_residual.launches,
            FB.mlp_fused.launches, attention_kernel.launches)


def zero_fused_counts() -> None:
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import attention_kernel

    zero_counts()
    FB.ln_linear.launches = FB.linear_residual.launches = 0
    FB.mlp_fused.launches = attention_kernel.launches = 0


def plain_block_fn(heads: int, policy, act, vv: bool = False):
    """``make_block_fn`` on the plain versions: the reference block."""
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import (attention_packed_plain,
                                                attention_packed_vv_plain)

    return FB.make_block_fn(
        heads, policy, act=act, vv=vv, ln=FB.ln_linear_plain,
        attention=attention_packed_vv_plain if vv else attention_packed_plain,
        residual=FB.linear_residual_plain, mlp=FB.mlp_fused_plain)


def phase_fused_predict(vit, adapter, cfg, acfg, anchors, M, card):
    """Phase 8c and the predict timings of 8e: returns {kernel: launches
    per bf16 predict call}."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.models.layers import config_act
    from aaclip_tpu_torch.ops.fused_block import make_block_fn

    heads, img, n_layers = cfg.vision.heads, cfg.vision.image_size, \
        cfg.vision.layers
    gen = torch.Generator(device="cuda").manual_seed(22)
    runs = {}
    for name, B in (("bf16", 8), ("fp32", 2)):
        policy = DtypePolicy.bf16() if name == "bf16" else DtypePolicy.fp32()
        act = config_act(cfg, policy)
        kw = dict(policy=policy, uint8_inputs=name == "bf16")
        fused = make_predict_fn(vit, cfg, acfg, block_fn=make_block_fn(
            heads, policy, act=act), **kw)
        plain = make_predict_fn(vit, cfg, acfg, block_fn=plain_block_fn(
            heads, policy, act), **kw)
        unfused = make_predict_fn(vit, cfg, acfg, **kw)
        if name == "bf16":
            images = torch.randint(0, 256, (B, 3, img, img), generator=gen,
                                   device="cuda", dtype=torch.uint8)
        else:
            images = torch.randn(B, 3, img, img, generator=gen,
                                 device="cuda")
        zero_fused_counts()
        pix_f, score_f = fused(adapter, images, anchors, M)
        torch.cuda.synchronize()
        c = fused_counts()
        zero_fused_counts()
        pix_p, score_p = plain(adapter, images, anchors, M)
        torch.cuda.synchronize()
        c_plain = fused_counts()
        pix_u, score_u = unfused(adapter, images, anchors, M)
        expect(pix_f.shape == (B, img, img) and score_f.shape == (B,),
               f"fused predict shapes {pix_f.shape}, {score_f.shape}")
        expect(bool(torch.isfinite(pix_f).all()
                    and torch.isfinite(score_f).all()),
               "fused predict not finite")
        expect(c == (n_layers, n_layers, 0, n_layers, n_layers, 0),
               f"fused predict launches {dict(zip(FUSED_COUNTED, c))}")
        expect(c_plain == (0,) * len(FUSED_COUNTED),
               f"plain-block predict launched {c_plain}")
        span = (pix_p.max() - pix_p.min()).item()
        d = (pix_f - pix_p).abs()
        dpix, dmean = d.max().item(), d.mean().item()
        dscore = (score_f - score_p).abs().max().item()
        u = (pix_f - pix_u).abs()
        upix, umean = u.max().item(), u.mean().item()
        print(f"fused predict {name} B={B}: launches per call ln_linear "
              f"{c[0]}, attention_packed {c[1]}, linear_residual {c[3]}, "
              f"mlp_fused {c[4]}, attention_kernel {c[5]}; vs the "
              f"plain-block predict: max|d map| {dpix:.3e} ({dpix / span:.3e}"
              f" of span {span:.4f}), mean|d map| {dmean:.3e} "
              f"({dmean / span:.3e} of span), max|d score| {dscore:.3e}; vs "
              f"the unfused predict (printed, not barred): max|d map| "
              f"{upix:.3e} ({upix / span:.3e} of span), mean|d map| "
              f"{umean:.3e} ({umean / span:.3e} of span), max|d score| "
              f"{(score_f - score_u).abs().max().item():.3e}")
        del d, u
        if name == "bf16":
            expect(dpix <= PIX_SPAN_FRAC_BF16 * span,
                   f"fused map off: {dpix} of {span}")
            expect(dscore <= SCORE_ATOL_BF16, f"fused scores off: {dscore}")
            launches = dict(zip(FUSED_COUNTED, c))
            fused_bf16, unfused_bf16 = fused, unfused
        else:
            torch.testing.assert_close(pix_f, pix_p, atol=PIX_ATOL_FP32,
                                       rtol=PIX_RTOL_FP32)
            torch.testing.assert_close(score_f, score_p,
                                       atol=SCORE_ATOL_FP32, rtol=0)
        del fused, plain, unfused, pix_f, pix_p, pix_u, images

    u8 = torch.randint(0, 256, (32, 3, img, img), generator=gen,
                       device="cuda", dtype=torch.uint8)
    ms_f = cuda_ms(lambda: fused_bf16(adapter, u8, anchors, M), 5)
    ms_u = cuda_ms(lambda: unfused_bf16(adapter, u8, anchors, M), 5)
    for name, ms in (("fused block", ms_f), ("unfused block", ms_u)):
        print(f"time predict bf16 B=32 ViT-L/518 ({name}): {ms:.2f} ms/call,"
              f" {32 / ms * 1e3:.2f} maps/s on {card}")
    return launches


def phase_encode_image(vit, cfg):
    """Phase 8d: ``encode_image`` with fused standard and V-V blocks
    against plain blocks, the launch counts, and a width-128 3-layer tower
    in fp32 on the card against the CPU."""
    import torch

    from aaclip_tpu_torch.core.config import (CLIPConfig, DtypePolicy,
                                              VisionConfig)
    from aaclip_tpu_torch.core.params import (cast_matmul_weights,
                                              init_vision_params)
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.models.vit import encode_image
    from aaclip_tpu_torch.ops import fused_block as FB

    heads, n_layers = cfg.vision.heads, cfg.vision.layers
    vv_start = L.surgery_vv_start(n_layers, STAGE1_SURGERY_UNTIL)
    bf16 = DtypePolicy.bf16()
    act = L.config_act(cfg, bf16)
    visual = cast_matmul_weights(vit, bf16)
    gen = torch.Generator(device="cuda").manual_seed(23)
    images = torch.randn(2, 3, cfg.vision.image_size, cfg.vision.image_size,
                         generator=gen, device="cuda")
    taps_at = (6, 12, 18, 24)

    widths = []

    def recording_ln_linear(x, *args):
        out = FB.ln_linear(x, *args)
        widths.append(out.shape[-1])
        return out

    fns = {vv: FB.make_block_fn(heads, bf16, act=act, vv=vv,
                                ln=recording_ln_linear)
           for vv in (False, True)}
    plain = {vv: plain_block_fn(heads, bf16, act, vv) for vv in (False, True)}
    with torch.inference_mode():
        zero_fused_counts()
        pooled_f, taps_f = encode_image(
            visual, cfg, images, taps_at, vv_start=vv_start, policy=bf16,
            block_fn=fns[False], vv_block_fn=fns[True])
        torch.cuda.synchronize()
        c = fused_counts()
        pooled_p, taps_p = encode_image(
            visual, cfg, images, taps_at, vv_start=vv_start, policy=bf16,
            block_fn=plain[False], vv_block_fn=plain[True])
    n_std = sum(w == 3 * cfg.vision.width for w in widths)
    print(f"encode_image bf16 B=2 vv_start={vv_start}: launches ln_linear "
          f"{c[0]} ({n_std} to {3 * cfg.vision.width} columns, "
          f"{len(widths) - n_std} to {cfg.vision.width}), attention "
          f"{c[1]} standard + {c[2]} V-V, linear_residual {c[3]}, "
          f"mlp_fused {c[4]}")
    expect(c == (n_layers, vv_start, n_layers - vv_start, n_layers,
                 n_layers, 0), f"encode_image launches {c}")
    expect(n_std == vv_start and len(widths) == n_layers,
           f"ln_linear widths {widths}")
    expect(pooled_f.shape == (2, cfg.embed_dim), f"pooled {pooled_f.shape}")
    for name, got, want in [("pooled", pooled_f[:, None], pooled_p[:, None])]\
            + [(f"tap {d}", t, tp) for d, t, tp in zip(taps_at, taps_f,
                                                       taps_p)]:
        expect(bool(torch.isfinite(got).all()), f"encode_image {name}")
        cos = torch.nn.functional.cosine_similarity(
            got.double(), want.double(), dim=-1).min().item()
        d = (got.float() - want.float()).abs().max().item()
        print(f"  encode_image {name}: fused vs plain blocks max|d| "
              f"{d:.3e}, least cosine {cos:.8f}")
        expect(cos >= ENC_COS, f"encode_image {name} off: cosine {cos}")
    del pooled_f, taps_f, pooled_p, taps_p, visual

    # width 128, 2 heads x 64, 3 layers, fp32: card (kernels) vs CPU
    small = CLIPConfig(embed_dim=64, vision=VisionConfig(
        image_size=28, patch_size=14, width=128, layers=3, heads=2))
    fp32 = DtypePolicy.fp32()
    outs = []
    for dev in ("cuda", "cpu"):
        sv = init_vision_params(small, seed=4, device="cpu")
        cpu_gen = torch.Generator().manual_seed(24)
        with torch.no_grad():
            for p in sv.parameters():  # no parameter the trivial 0 or 1
                p.add_(torch.randn(p.shape, generator=cpu_gen) * 0.05)
        sv = sv.to(dev)
        x = torch.randn(2, 3, 28, 28, generator=cpu_gen).to(dev)
        fns = {vv: FB.make_block_fn(2, fp32, act=L.gelu, vv=vv)
               for vv in (False, True)}
        with torch.inference_mode():
            pooled, taps = encode_image(sv, small, x, (2, 3), vv_start=2,
                                        policy=fp32, block_fn=fns[False],
                                        vv_block_fn=fns[True])
        outs.append([t.cpu() for t in (pooled, *taps)])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=TINY_ATOL, rtol=TINY_RTOL)
    print("encode_image width 128 fp32 (fused blocks, standard and V-V): "
          "card (kernels) matches the CPU")


def compare_tile_widths(FB, calls: dict, card) -> None:
    """Phase 8e: the bf16 wrappers at the batch-32 shapes with every GEMM
    on output tiles of fused_block.cu's own width (``rule``), then of 128
    and of 256 columns (``gemm_tile_width``): ms per call by CUDA events,
    and each GEMM's device ms per launch by the profiler, under its
    kernel's name, which carries the tile width (``gemm_wgmma<BN, LN,
    EPI>``: B5 is ln_linear's, B6 linear_residual's; fc is mlp_fused's LN
    GEMM, proj its other)."""
    for bn in (0, 128, 256):
        FB.gemm_tile_width(bn)
        try:
            for name, fn in calls.items():
                ms = cuda_ms(fn, 20)
                gemms = "; ".join(
                    f"{k[k.index('gemm_wgmma'):].split('(')[0]} "
                    f"{us / n / 1e3:.4f} ms"
                    for k, (n, us) in sorted(device_ops(fn, 10).items())
                    if "gemm_wgmma" in k)
                print(f"tile {bn or 'rule'}: {name} {ms:.4f} ms per call; "
                      f"per GEMM launch (profiler): {gemms} on {card}")
        finally:
            FB.gemm_tile_width(0)


def time_fused(cfg, card):
    """Phase 8e: each fused kernel, its plain version and the library
    yardstick at the batch-32 shapes, with the device operations of one
    call (the profiler's count, which must be the kernels' own) and the
    GEMM's tile widths against each other; returns {name: (ms, plain ms,
    library ms, bound ms, bound_by, kernels per call)}."""
    import torch

    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_kernel_plain)

    bf16 = DtypePolicy.bf16()
    D, F, B, S = cfg.vision.width, int(cfg.vision.width *
                                       cfg.vision.mlp_ratio), 32, \
        cfg.vision.seq_len
    R = B * S
    gen = torch.Generator(device="cuda").manual_seed(25)
    t = fused_inputs(B, S, D, F, torch.bfloat16, gen)
    x, g, b = t["x"], t["g"], t["b"]
    wqkv = torch.randn(3 * D, D, generator=gen, device="cuda").mul(
        D ** -0.5).to(torch.bfloat16)
    bqkv = torch.randn(3 * D, generator=gen, device="cuda").mul(0.02).to(
        torch.bfloat16)
    y = torch.randn(B, S, D, generator=gen, device="cuda").to(torch.bfloat16)
    wo, bo = t["w"][:D].contiguous(), t["bias"][:D].contiguous()
    act = L.gelu_tanh
    e = 2  # bytes of a bf16 element

    def unfused_ln_linear():
        h = L.layer_norm(x, g, b)
        return L.linear(h, wqkv, bqkv, bf16).to(bf16.compute_dtype)

    def unfused_linear_residual():
        return x + L.linear(y, wo, bo, bf16).to(x.dtype)

    mlp_p = SimpleNamespace(
        c_fc=SimpleNamespace(weight=t["w"], bias=t["bias"]),
        c_proj=SimpleNamespace(weight=t["w2"], bias=t["bias2"]))

    def unfused_mlp():
        return x + L.mlp(L.layer_norm(x, g, b), mlp_p, act, bf16)

    cases = {
        "ln_linear": (
            functools.partial(FB.ln_linear, x, g, b, wqkv, bqkv, bf16),
            lambda: FB.ln_linear_plain(x, g, b, wqkv, bqkv, bf16),
            unfused_ln_linear, 2 * R * D * 3 * D,
            (R * D + 3 * D * D + 3 * D + 2 * D + R * 3 * D) * e),
        "linear_residual": (
            functools.partial(FB.linear_residual, x, y, wo, bo, bf16),
            lambda: FB.linear_residual_plain(x, y, wo, bo, bf16),
            unfused_linear_residual, 2 * R * D * D,
            (3 * R * D + D * D + D) * e),
        "mlp_fused": (
            functools.partial(FB.mlp_fused, x, g, b, t["w"], t["bias"],
                              t["w2"], t["bias2"], act, bf16),
            lambda: FB.mlp_fused_plain(x, g, b, t["w"], t["bias"], t["w2"],
                                       t["bias2"], act, bf16),
            unfused_mlp, 4 * R * D * F,
            (2 * R * D + 2 * D * F + F + 3 * D) * e),
    }
    per_call = {"ln_linear": {"row_stats_kernel": 1, "gemm_wgmma": 1},
                "linear_residual": {"gemm_wgmma": 1},
                "mlp_fused": {"row_stats_kernel": 1, "gemm_wgmma": 2}}
    out = {}
    with torch.inference_mode():
        for name, (kern, plain, lib, flops, nbytes) in cases.items():
            ms = cuda_ms(kern, 20)
            n = kernels_per_call(kern, "fused_block", per_call[name], name)
            ms_plain = cuda_ms(plain, 5)
            ms_lib = cuda_ms(lib, 20)
            bound_ms, bound_by = bound(flops, nbytes)
            out[name] = (ms, ms_plain, ms_lib, bound_ms, bound_by, n)
            print(f"time {name} [{B},{S},{D}] bf16: kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain {ms_plain:.4f}, "
                  f"unfused sequence {ms_lib:.4f}; bound {bound_ms:.4f} ms "
                  f"by {bound_by} on {card}")
        del t, x, y, wqkv
        H, hd = cfg.vision.heads, cfg.vision.head_dim
        q, k, v = (torch.randn(B, H, S, hd, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        b4 = functools.partial(attention_kernel, q, k, v, S)
        ms = cuda_ms(b4, 20)
        n = kernels_per_call(b4, "attention_packed", {"attn_fwd_wgmma": 1},
                             "attention_kernel")
        ms_plain = cuda_ms(lambda: attention_kernel_plain(q, k, v, S), 5)
        ms_lib = cuda_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(q, k, v), 20)
        flops = 4 * B * H * S * S * hd
        bound_ms, bound_by = bound(flops, 4 * q.numel() * q.element_size())
        out["attention_kernel"] = (ms, ms_plain, ms_lib, bound_ms, bound_by,
                                   n)
        print(f"time attention_kernel [{B},{H},{S},{hd}] bf16: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{ms_plain:.4f}, sdpa {ms_lib:.4f}; bound {bound_ms:.4f} ms by "
              f"{bound_by} on {card}")
        # last: it traces, and a traced process times host-bound work
        # slower (check_device_ops)
        compare_tile_widths(FB, {name: c[0] for name, c in cases.items()},
                            card)
    return out


# Phase 9, the evaluation CLI from checkpoints, on a synthetic MVTec set
# sized like the real one: four classes of 150 test images (50 normal, 100
# anomalous) at 1024 px (MVTec AD's classes hold 42-167 test images of
# 700-1024 px), so the CLI's logged rate, which leaves out the first
# class, covers 450 maps. (b) the CLI against a direct predict on the same
# loaded towers and batches: bit for bit (the same kernels and products at
# the same shapes). (c) the kernel run against the same loop on the plain
# attention: phase 4's bars on the scores, at fp32 on the maps too, and
# the tables within 0.01 points at fp32 (a rounding may flip). The bf16
# map and table are held against a second bf16 attention, the
# library's (SDPA through the same projections): phase 4's bar (kernel
# within 1e-2 of the plain map's span) is below what any two bf16
# attentions agree to on these flat maps (plain span 0.629-0.672). Read
# on an NVIDIA H100 80GB HBM3, 700 W, over the four classes, as fractions
# of the span: max |kernel - plain| 1.525-1.930e-2, max |SDPA - plain|
# 1.634-2.236e-2; mean 2.552-2.799e-3 and 2.540-2.823e-3; max from the
# fp32 map: kernel 2.226-2.733e-2, plain 2.245-3.092e-2, SDPA
# 2.340-3.005e-2. So the kernel's mean distance from the plain map may be
# at most 1.1x SDPA's (read: 1.005x at most) and its max distance 1.5x
# SDPA's (read: 1.165x; a max over 40M pixels scatters more) or phase
# 4's bar. The bf16 table: each cell within 1.0 point of the plain table
# beyond SDPA's distance from it in the same cell. The image AUROC/AP
# rank 150 near-tied images by half their map's maximum, which that
# scatter moves, so one cell can jump by a point: read, the kernel's
# table lies up to 1.06 points from plain (cable's image AP, where SDPA
# lies 0.46 from plain), SDPA's up to 0.54, the two up to 0.60 apart.
# (d) the 3-pass M q Mᵀ (JAX's precision "high") against fp64: 1e-5 of the
# map's span, JAX's stated error (read on an NVIDIA H100 80GB HBM3, 700 W:
# 7.375e-6; true fp32 1.142e-7).
EVAL_TABLE_ATOL = {"fp32": 0.01, "bf16": 1.0}
VS_SDPA_MEAN, VS_SDPA_MAX = 1.1, 1.5
PP_3PASS_SPAN_FRAC = 1e-5
EVAL_CLASSES, EVAL_NORMAL, EVAL_ANOMALOUS, EVAL_PX = 4, 50, 100, 1024
EVAL_RUNS = (("bf16", 32), ("fp32", 8))
DECODE_SAMPLE = 16  # images and masks timed one at a time on the host


def sdpa_packed(qkv, num_heads: int, valid_len: int):
    """The library's attention (``scaled_dot_product_attention``) on a
    packed [B, S, 3*D] qkv, in ``attention_packed_plain``'s signature."""
    import torch

    B, S, D3 = qkv.shape
    expect(valid_len == S, f"sdpa_packed takes no padding ({valid_len}/{S})")
    hd = D3 // 3 // num_heads
    q, k, v = qkv.view(B, S, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).reshape(B, S, D3 // 3)


def time_host_decode(images, masks, tmp, img, card) -> None:
    """Decode and resize ``DECODE_SAMPLE`` images and masks one at a time:
    the files as written (every row filter None: the row-by-row unfilter)
    and the same pixels rewritten with every row Paeth (the anti-diagonal
    unfilter, which files with Average or Paeth rows take: libpng's and
    Pillow's adaptive filtering write them)."""
    import os

    import numpy as np

    from aaclip_tpu_torch.data.image import (encode_png, load_gray, load_rgb,
                                             resize_bicubic, resize_nearest)

    sample = images[:DECODE_SAMPLE]
    paeth_dir = os.path.join(tmp, "paeth")
    os.makedirs(paeth_dir)
    paeth = []
    for i, f in enumerate(sample):
        paeth.append(os.path.join(paeth_dir, f"{i:03d}.png"))
        with open(paeth[-1], "wb") as out:
            out.write(encode_png(load_rgb(f), 4))
    for what, files in (("filter None (rows)", sample),
                        ("filter Paeth (anti-diagonals)", paeth)):
        t0 = time.perf_counter()
        decoded = [load_rgb(f) for f in files]
        dec_ms = (time.perf_counter() - t0) / len(files) * 1e3
        t0 = time.perf_counter()
        for x in decoded:
            resize_bicubic(x, img)
        res_ms = (time.perf_counter() - t0) / len(files) * 1e3
        print(f"eval CLI host, one thread, {EVAL_PX} px RGB PNG, {what}: "
              f"decode {dec_ms:.2f} + bicubic resize to {img} px "
              f"{res_ms:.2f} = {dec_ms + res_ms:.2f} ms per image on {card}")
        if files is paeth:
            expect(all(np.array_equal(load_rgb(a), b)
                       for a, b in zip(sample, decoded)),
                   "Paeth-filtered files decode to other pixels")
    t0 = time.perf_counter()
    for f in masks[:DECODE_SAMPLE]:
        resize_nearest(load_gray(f), img)
    mask_ms = (time.perf_counter() - t0) / DECODE_SAMPLE * 1e3
    print(f"eval CLI host, one thread: {EVAL_PX} px mask decode + nearest "
          f"resize {mask_ms:.2f} ms per mask on {card}")


def openai_state_dict(vit, text) -> dict:
    """The towers as an OpenAI-layout CLIP state dict on the host (what
    ``core/params.py::load_openai_checkpoint`` reads)."""
    import math

    import torch

    def blocks(tower, prefix):
        return {f"{prefix}.{i}.{k}": v for i, blk in enumerate(tower.blocks)
                for k, v in blk.state_dict().items()}

    v = {k: t for k, t in vit.state_dict().items()
         if not k.startswith("blocks.")}
    w = v.pop("conv1.weight")
    sd = {"visual." + k: t for k, t in v.items()}
    sd["visual.conv1.weight"] = w.reshape(w.shape[0], 3, 14, 14)
    sd.update(blocks(vit, "visual.transformer.resblocks"))
    sd.update({k: t for k, t in text.state_dict().items()
               if not k.startswith("blocks.")})
    sd.update(blocks(text, "transformer.resblocks"))
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    return {k: t.detach().cpu().contiguous() for k, t in sd.items()}


def table_distance(rows_a, rows_b) -> float:
    """The largest difference of two tables' cells, in points (the rows'
    class names must agree)."""
    expect([r[0] for r in rows_a] == [r[0] for r in rows_b],
           "the tables' classes differ")
    return max(abs(a - b) for ra, rb in zip(rows_a, rows_b)
               for a, b in zip(ra[1:], rb[1:]))


def read_csv(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def phase_eval_cli(card) -> None:
    """Phase 9: ``aaclip_tpu_torch.test.main`` at ViT-L-14-336 @ 518 from a
    saved OpenAI-layout checkpoint (the pos embed resized 24 -> 37), an npz
    image adapter and a reference ``.pth`` text adapter, on a synthetic
    MVTec set of real size, once per ``EVAL_RUNS`` entry, held to (a) 24
    kernel launches per predict batch and no other kernel, (b), (c) and
    (d) above; the host's decode and resize timed beside it."""
    import gc
    import os
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aaclip_tpu_torch import test as cli
    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_image_adapter,
                                              init_text_adapter,
                                              init_text_params,
                                              init_vision_params,
                                              text_adapter_from_jax,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.datasets import BatchLoader, get_test_datasets
    from aaclip_tpu_torch.data.registry import CLASS_NAMES
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.eval.metrics import metrics_eval
    from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                               make_predict_fn,
                                               run_class_predictions)
    from aaclip_tpu_torch.kernels.build import kernels_launched
    from aaclip_tpu_torch.ops import fused_block as FB
    from aaclip_tpu_torch.ops.attention import (attention_kernel,
                                                attention_packed_plain,
                                                make_attn_fn)
    from aaclip_tpu_torch.ops.similarity import (apply_postproc_matrix,
                                                 fused_postproc_matrix)
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors
    from aaclip_tpu_torch.train import checkpoint as ckpt

    cfg = get_config("ViT-L-14-336", img_size=518)
    img, grid, n_layers = (cfg.vision.image_size, cfg.vision.grid,
                           cfg.vision.layers)
    acfg = AdapterConfig()
    tmp = tempfile.mkdtemp(prefix="aaclip_eval_cli_")
    env_before = {k: os.environ.get(k) for k in ("AACLIP_DATA",
                                                 "AACLIP_METADATA")}
    try:
        # 1. a seeded ViT-L at its native 336 px grid, saved OpenAI-style
        native = get_config("ViT-L-14-336", img_size=336)
        sd = openai_state_dict(init_vision_params(native, seed=7),
                               init_text_params(native, seed=8))
        expect(sd["visual.positional_embedding"].shape == (577, 1024),
               "the checkpoint is not at the 24x24 grid")
        ckpt_path = os.path.join(tmp, "ViT-L-14-336.pt")
        t0 = time.perf_counter()
        torch.save(sd, ckpt_path)
        save_s = time.perf_counter() - t0
        size_gb = os.path.getsize(ckpt_path) / 1e9
        del sd
        # 2. the adapters: npz image snapshot, reference .pth text adapter
        ad_tree = adapter_to_jax(init_image_adapter(cfg, acfg, seed=9,
                                                    device="cpu"))
        text_sd, _ = ckpt.adapters_to_torch_state_dicts(
            {"text": text_adapter_to_jax(init_text_adapter(
                cfg, acfg, seed=10, device="cpu")), "image": ad_tree},
            proj_relu=False)
        adapters = os.path.join(tmp, "adapters")
        ckpt.save_adapter_checkpoint(
            os.path.join(adapters, "image_adapter_1.npz"), 1, ad_tree)
        torch.save({"epoch": 0, "text_adapter": text_sd},
                   os.path.join(adapters, "text_adapter.pth"))
        print(f"eval CLI: checkpoint {size_gb:.3f} GB saved in {save_s:.2f} "
              f"s on {card}")
        # 3. the synthetic dataset
        classes = CLASS_NAMES["MVTec"][:EVAL_CLASSES]
        per_class = EVAL_NORMAL + EVAL_ANOMALOUS
        t0 = time.perf_counter()
        data_root, meta_root = make_synthetic_dataset(
            os.path.join(tmp, "synthetic"), class_names=classes,
            n_normal=EVAL_NORMAL, n_anomalous=EVAL_ANOMALOUS, img_px=EVAL_PX,
            hard=True)
        os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
        files = sorted(os.path.join(d, f) for d, _, fs in
                       os.walk(data_root) for f in fs)
        images = [f for f in files if not f.endswith("_mask.png")]
        masks = [f for f in files if f.endswith("_mask.png")]
        expect(len(images) == EVAL_CLASSES * per_class
               and len(masks) == EVAL_CLASSES * EVAL_ANOMALOUS,
               f"{len(images)} synthetic images, {len(masks)} masks")
        print(f"eval CLI: synthetic MVTec {', '.join(classes)}: "
              f"{len(images)} images of {EVAL_PX} px, {len(masks)} masks, "
              f"{sum(map(os.path.getsize, files)) / 1e9:.3f} GB written in "
              f"{time.perf_counter() - t0:.1f} s")
        time_host_decode(images, masks, tmp, img, card)

        # the direct path's towers, loaded as the CLI loads them
        t0 = time.perf_counter()
        vit, text = create_clip_towers(cfg, checkpoint=ckpt_path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"eval CLI: checkpoint loaded into the towers on the card in "
              f"{load_s:.2f} s (pos embed {tuple(vit.positional_embedding.shape)})"
              f" on {card}")
        image_adapter = adapter_from_jax(ad_tree, cfg, acfg)
        _, tree = ckpt.load_reference_checkpoint(
            os.path.join(adapters, "text_adapter.pth"), "text",
            n_adapt=acfg.text_adapt_until)
        text_adapter = text_adapter_from_jax(tree, cfg, acfg)

        for name, B in EVAL_RUNS:
            policy = DtypePolicy.from_name(name)
            save = os.path.join(tmp, f"run_{name}")
            shutil.copytree(adapters, save)
            zero_fused_counts()
            before = kernels_launched("attention_packed")
            t0 = time.perf_counter()
            cli.main(["--clip_checkpoint", ckpt_path, "--save_path", save,
                      "--precision", name, "--batch_size", str(B), "--csv",
                      "--dump_scores"])
            wall = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            # (a) 24 launches per predict batch, no other kernel
            n_batches = EVAL_CLASSES * -(-per_class // B)
            n_lib = kernels_launched("attention_packed") - before
            counts_now = dict(zip(("standard", "vv", "bwd"), counts()))
            others = {"attention_kernel": attention_kernel.launches,
                      "ln_linear": FB.ln_linear.launches,
                      "linear_residual": FB.linear_residual.launches,
                      "mlp_fused": FB.mlp_fused.launches}
            print(f"eval CLI {name} B={B}: {n_batches} predict batches, "
                  f"attention_packed {counts_now['standard']} launches "
                  f"({n_lib} kernels counted by the library), V-V "
                  f"{counts_now['vv']}, backward {counts_now['bwd']}, "
                  f"{others}")
            expect(counts_now["standard"] == n_layers * n_batches == n_lib,
                   f"eval CLI {name}: {counts_now['standard']} launches, "
                   f"{n_lib} kernels, not {n_layers} x {n_batches}")
            expect(counts_now["vv"] == counts_now["bwd"] == 0
                   and not any(others.values()),
                   f"eval CLI {name}: other kernels ran: {counts_now}, "
                   f"{others}")
            log = open(os.path.join(save, "test.log")).read()
            rate = float(re.search(r"eval throughput: ([\d.]+) maps/s",
                                   log).group(1))
            print(f"eval CLI {name} B={B}: {rate:.2f} maps/s logged (eval "
                  f"throughput, the first class excluded); {wall:.2f} s "
                  f"for the whole main() on {card}")

            # (b) the CLI's scores equal a direct predict, bit for bit
            uint8 = name == "bf16"
            heads = cfg.vision.heads
            kernel = make_predict_fn(vit, cfg, acfg, policy=policy,
                                     uint8_inputs=uint8)
            plain = make_predict_fn(
                vit, cfg, acfg, policy=policy, uint8_inputs=uint8,
                attn_fn=make_attn_fn(heads, policy,
                                     attention=attention_packed_plain))
            library = make_predict_fn(
                vit, cfg, acfg, policy=policy, uint8_inputs=uint8,
                attn_fn=make_attn_fn(heads, policy, attention=sdpa_packed))
            exact = make_predict_fn(vit, cfg, acfg,
                                    policy=DtypePolicy.fp32(),
                                    uint8_inputs=uint8)
            anchors = encode_dataset_anchors(
                make_anchor_encoder(text, cfg, acfg, text_adapter,
                                    policy=policy), "MVTec")
            scores = read_csv(os.path.join(save, "scores_1.csv"))[1:]
            table = read_csv(os.path.join(save, "results_1.csv"))
            plain_rows, lib_rows = [], []
            dpix_rel = dscore = 0.0
            bf16_maps = {}
            host_s = {"loader": [], "metrics": []}
            for cls, ds in get_test_datasets("MVTec", img,
                                             uint8=uint8).items():
                if len(ds) == 0:
                    continue
                t0 = time.perf_counter()
                batches = list(BatchLoader(ds, B, num_workers=4))
                host_s["loader"].append(time.perf_counter() - t0)
                got = run_class_predictions(kernel, image_adapter, batches,
                                            anchors[cls], "Industrial", img,
                                            grid)
                mine = [r for r in scores if r[0] == cls]
                expect([r[1] for r in mine] == got[4]
                       and [int(r[2]) for r in mine] == got[1].tolist(),
                       f"eval CLI {name} {cls}: files or labels differ")
                expect([float(r[3]) for r in mine]
                       == [float(x) for x in got[3]],
                       f"eval CLI {name} {cls}: scores differ from the "
                       f"direct predict")
                # (c) the plain attention on the same batches
                ref = run_class_predictions(plain, image_adapter, batches,
                                            anchors[cls], "Industrial", img,
                                            grid)
                span = float(ref[2].max() - ref[2].min())
                dpix = float(np.abs(got[2] - ref[2]).max())
                dpix_rel = max(dpix_rel, dpix / span)
                dscore = max(dscore, float(np.abs(got[3] - ref[3]).max()))
                if name == "bf16":
                    lib = run_class_predictions(
                        library, image_adapter, batches, anchors[cls],
                        "Industrial", img, grid)
                    f32 = run_class_predictions(
                        exact, image_adapter, batches, anchors[cls],
                        "Industrial", img, grid)[2]
                    span32 = float(f32.max() - f32.min())
                    r = {"span": span, "kernel-plain": dpix / span,
                         "sdpa-plain": float(np.abs(lib[2] - ref[2]).max())
                         / span,
                         "kernel-plain mean": float(np.abs(got[2] - ref[2])
                                                    .mean()) / span,
                         "sdpa-plain mean": float(np.abs(lib[2] - ref[2])
                                                  .mean()) / span}
                    for k, m in (("kernel", got[2]), ("plain", ref[2]),
                                 ("sdpa", lib[2])):
                        r[f"{k}-fp32"] = float(np.abs(m - f32).max()) / span32
                    bf16_maps[cls] = r
                    expect(dscore <= SCORE_ATOL_BF16,
                           f"eval CLI bf16 {cls}: scores off by {dscore}")
                else:
                    torch.testing.assert_close(
                        torch.from_numpy(got[2]), torch.from_numpy(ref[2]),
                        atol=PIX_ATOL_FP32, rtol=PIX_RTOL_FP32)
                    torch.testing.assert_close(
                        torch.from_numpy(got[3]), torch.from_numpy(ref[3]),
                        atol=SCORE_ATOL_FP32, rtol=0)
                t0 = time.perf_counter()
                row = metrics_eval(ref[0], ref[1], ref[2], ref[3], cls,
                                   "Industrial")
                host_s["metrics"].append(time.perf_counter() - t0)
                plain_rows.append([cls] + [float(row[c])
                                           for c in table[0][1:]])
                if name == "bf16":
                    row = metrics_eval(ref[0], ref[1], lib[2], lib[3], cls,
                                       "Industrial")
                    lib_rows.append([cls] + [float(row[c])
                                             for c in table[0][1:]])
            for rows in (plain_rows, lib_rows):
                if rows:
                    rows.append(["Average"] + [
                        sum(r[i] for r in rows) / len(rows)
                        for i in range(1, len(table[0]))])
            print(f"eval CLI {name} host, per class of {per_class} images: "
                  f"the loader (the CLI's, 4 threads) "
                  f"{', '.join(f'{t:.2f}' for t in host_s['loader'])} s, "
                  f"metrics_eval (pixel and image AUROC/AP) "
                  f"{', '.join(f'{t:.2f}' for t in host_s['metrics'])} s "
                  f"on {card}")
            print(f"eval CLI {name}: the CLI's scores equal the direct "
                  f"predict's bit for bit; kernel vs plain attention: max|d "
                  f"map| {dpix_rel:.3e} of the span, max|d score| "
                  f"{dscore:.3e}")
            for cls, r in bf16_maps.items():
                print(f"eval CLI bf16 {cls}: plain map span {r['span']:.4f}; "
                      f"max|d map| of the span: kernel vs plain "
                      f"{r['kernel-plain']:.3e} (phase 4's bar "
                      f"{PIX_SPAN_FRAC_BF16}), SDPA vs plain "
                      f"{r['sdpa-plain']:.3e}; mean: kernel vs plain "
                      f"{r['kernel-plain mean']:.3e}, SDPA vs plain "
                      f"{r['sdpa-plain mean']:.3e}; vs the fp32 map: kernel "
                      f"{r['kernel-fp32']:.3e}, plain {r['plain-fp32']:.3e}, "
                      f"SDPA {r['sdpa-fp32']:.3e}")
            for cls, r in bf16_maps.items():
                expect(r["kernel-plain mean"]
                       <= VS_SDPA_MEAN * r["sdpa-plain mean"]
                       and r["kernel-plain"] <= max(
                           PIX_SPAN_FRAC_BF16,
                           VS_SDPA_MAX * r["sdpa-plain"]),
                       f"eval CLI bf16 {cls}: the kernel's map lies "
                       f"{r['kernel-plain mean']} (mean) and "
                       f"{r['kernel-plain']} (max) of the span from the "
                       f"plain map, SDPA's {r['sdpa-plain mean']} and "
                       f"{r['sdpa-plain']}")
            kernel_rows = [[r[0]] + [float(x) for x in r[1:]]
                           for r in table[1:]]
            print(f"eval CLI {name}: the CLI's table (kernel attention):\n"
                  + cli.format_table(table[0], kernel_rows))
            print(f"eval CLI {name}: the same loop on the plain attention:\n"
                  + cli.format_table(table[0], plain_rows))
            dtable = table_distance(kernel_rows, plain_rows)
            print(f"eval CLI {name}: the kernel's table differs from the "
                  f"plain one by at most {dtable:.4f} points")
            if lib_rows:
                print(f"eval CLI {name}: the same loop on SDPA:\n"
                      + cli.format_table(table[0], lib_rows))
                print(f"eval CLI {name}: SDPA's table differs from the "
                      f"plain one by at most "
                      f"{table_distance(lib_rows, plain_rows):.4f} points, "
                      f"from the kernel's by at most "
                      f"{table_distance(lib_rows, kernel_rows):.4f}")
                dtable = max(abs(k - p) - abs(q - p) for rk, rp, rq in
                             zip(kernel_rows, plain_rows, lib_rows)
                             for k, p, q in zip(rk[1:], rp[1:], rq[1:]))
                print(f"eval CLI {name}: beyond SDPA's distance from the "
                      f"plain table in the same cell, the kernel's lies at "
                      f"most {dtable:.4f} points from it")
            expect(dtable <= EVAL_TABLE_ATOL[name],
                   f"eval CLI {name}: tables differ by {dtable} points (bar "
                   f"{EVAL_TABLE_ATOL[name]})")
            del kernel, plain, library, exact
            gc.collect()
            torch.cuda.empty_cache()

        # (d) the 3-pass M q Mᵀ against fp64
        gen = torch.Generator(device="cuda").manual_seed(9)
        q = torch.randn(32, grid, grid, generator=gen, device="cuda") * 10 + 2
        M = torch.from_numpy(fused_postproc_matrix(grid, img,
                                                   "Industrial")).cuda()
        exact = torch.einsum("Ig,bgh,Jh->bIJ", M.double(), q.double(),
                             M.double())
        span = (exact.max() - exact.min()).item()
        errs = {p: (apply_postproc_matrix(q, M, p).double() - exact).abs()
                .max().item() / span for p in ("high", "highest")}
        print(f"M q Mᵀ on the card vs fp64 [32, {img}, {img}]: 3-pass "
              f"{errs['high']:.3e} of the span (bar {PP_3PASS_SPAN_FRAC}), "
              f"fp32 {errs['highest']:.3e}")
        expect(errs["high"] <= PP_3PASS_SPAN_FRAC,
               f"3-pass M q Mᵀ off by {errs['high']} of the span")
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from aaclip_tpu_torch.core.config import AdapterConfig, get_config
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.device import card_line
    from aaclip_tpu_torch.kernels.build import KERNELS, build_all
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")

    # -- 2. build
    t0 = time.perf_counter()
    built = build_all()
    print(f"built {', '.join(p.name for p, _ in built.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in built[name][1].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "(C75")):  # C75xx: wgmma notes
                print(f"  nvcc {name}:", line.strip())

    # -- 3. kernels vs plain
    print(f"[{time.perf_counter() - t0:.0f} s] kernels vs plain")
    err_fwd = max(check_kernel(d) for d in DTYPES)
    err_bwd = max(check_bwd_kernel(d) for d in DTYPES)
    for d in DTYPES:
        check_tail_isolation(d)
    check_matmul_f32_grad()
    err_vv = max(check_vv_kernel(d) for d in DTYPES)

    cfg = get_config("ViT-L-14-336", img_size=518)
    acfg = AdapterConfig()
    vit = init_vision_params(cfg, seed=0)
    adapter = init_image_adapter(cfg, acfg, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    anchors = torch.randn(cfg.embed_dim, 2, generator=gen, device="cuda")
    anchors = anchors / anchors.norm(dim=0, keepdim=True)
    M = torch.from_numpy(fused_postproc_matrix(cfg.vision.grid, 518,
                                               "Industrial")).cuda()

    # -- 4, 6a. inference path
    print(f"[{time.perf_counter() - t0:.0f} s] inference path")
    (fwd_launches, fwd_per_call, ms_fwd, ms_fwd_plain, ms_sdpa, fwd_bound,
     fwd_bound_by) = phase_predict(vit, adapter, cfg, acfg, anchors, M, card,
                                   gen)
    # -- 5, 6b. stage-2 training step
    print(f"[{time.perf_counter() - t0:.0f} s] stage-2 step")
    train_fwd, train_bwd = phase_train(vit, adapter, cfg, acfg, card)
    expect(train_fwd == fwd_launches, "forward launches differ by path")
    # -- 6c. backward timings
    print(f"[{time.perf_counter() - t0:.0f} s] backward timings")
    (bwd_per_call, ms_bwd, ms_bwd_plain, ms_sdpa_bwd, bwd_bound,
     bwd_bound_by) = time_bwd(cfg, card)

    # -- 7. stage-1 path
    print(f"[{time.perf_counter() - t0:.0f} s] stage-1 path")
    (vv_launches, vv_per_call, ms_vv, ms_vv_plain, ms_vv_sdpa, vv_bound,
     vv_bound_by) = phase_stage1(vit, cfg, card)

    # -- 8. fused-block path
    print(f"[{time.perf_counter() - t0:.0f} s] fused-block path")
    err_fused = {}
    for d in DTYPES:
        for name, err in check_fused_kernels(d).items():
            err_fused[name] = max(err_fused.get(name, 0.0), err)
        check_fused_nan_row(d)
    err_b4 = max(check_attention_kernel(d) for d in DTYPES)
    fused_launches = phase_fused_predict(vit, adapter, cfg, acfg, anchors,
                                         M, card)
    expect(fused_launches["attention_packed"] == fwd_launches,
           "the fused predict's attention launches differ from the "
           "predict's")
    phase_encode_image(vit, cfg)
    fused_times = time_fused(cfg, card)

    # -- 9. the evaluation CLI from checkpoints
    print(f"[{time.perf_counter() - t0:.0f} s] evaluation CLI")
    phase_eval_cli(card)
    check_device_ops()

    print(f"[{time.perf_counter() - t0:.0f} s] done")
    # (name, source, replaces, launches, max |d|)
    fused_rows = [
        ("attention_kernel", "attention_packed.cu",
         "aaclip_tpu/ops/flash_attention.py:94",
         fused_launches["attention_kernel"], err_b4),
        ("ln_linear", "fused_block.cu", "aaclip_tpu/ops/fused_block.py:124",
         fused_launches["ln_linear"], err_fused["ln_linear"]),
        ("linear_residual", "fused_block.cu",
         "aaclip_tpu/ops/fused_block.py:179",
         fused_launches["linear_residual"], err_fused["linear_residual"]),
        ("mlp_fused", "fused_block.cu", "aaclip_tpu/ops/fused_block.py:244",
         fused_launches["mlp_fused"], err_fused["mlp_fused"]),
    ]
    print(json.dumps({"kernels": [{
        "name": "attention_packed",
        "route": "cuda",
        "source": "aaclip_tpu_torch/kernels/csrc/attention_packed.cu",
        "replaces": "aaclip_tpu/ops/flash_attention.py:190",
        "launches": fwd_launches,
        "kernels_per_call": fwd_per_call,
        "max_abs_err": err_fwd,
        "ms": ms_fwd,
        "plain_ms": ms_fwd_plain,
        "bound_ms": fwd_bound,
        "bound_by": fwd_bound_by,
        "library_ms": ms_sdpa,
    }, {
        "name": "attention_packed_bwd",
        "route": "cuda",
        "source": "aaclip_tpu_torch/kernels/csrc/attention_packed_bwd.cu",
        "replaces": "aaclip_tpu/ops/flash_attention.py:302",
        "launches": train_bwd,
        "kernels_per_call": bwd_per_call,
        "max_abs_err": err_bwd,
        "ms": ms_bwd,
        "plain_ms": ms_bwd_plain,
        "bound_ms": bwd_bound,
        "bound_by": bwd_bound_by,
        "library_ms": ms_sdpa_bwd,
    }, {
        "name": "attention_packed_vv",
        "route": "cuda",
        "source": "aaclip_tpu_torch/kernels/csrc/attention_packed.cu",
        "replaces": "aaclip_tpu/ops/flash_attention.py:190",
        "launches": vv_launches,
        "kernels_per_call": vv_per_call,
        "max_abs_err": err_vv,
        "ms": ms_vv,
        "plain_ms": ms_vv_plain,
        "bound_ms": vv_bound,
        "bound_by": vv_bound_by,
        "library_ms": ms_vv_sdpa,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"aaclip_tpu_torch/kernels/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "kernels_per_call": fused_times[name][5],
        "max_abs_err": err,
        "ms": fused_times[name][0],
        "plain_ms": fused_times[name][1],
        "bound_ms": fused_times[name][3],
        "bound_by": fused_times[name][4],
        "library_ms": fused_times[name][2],
    } for name, source, replaces, launches, err in fused_rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

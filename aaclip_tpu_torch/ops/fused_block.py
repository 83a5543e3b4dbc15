"""The fused residual block: the wrappers around the hand-written CUDA
kernels of ``kernels/csrc/fused_block.cu``, their plain PyTorch versions,
and the whole-block override ``block_fn`` that chains them around the
packed attention.

They replace ``aaclip_tpu/ops/fused_block.py``:

* ``ln_linear``       -- LayerNorm -> matmul -> + bias (ln_1 -> packed QKV);
* ``linear_residual`` -- res + (matmul + bias) (attention out-projection);
* ``mlp_fused``       -- x + proj(act(fc(LayerNorm(x)))).

``make_block_fn`` runs a block as ``ln_linear`` -> packed attention ->
``linear_residual`` -> ``mlp_fused``, the JAX package's inference-only
override of ``models/layers.residual_block``; the JAX TPU tile knobs
(``q_blk``, ``r_blk``, ``mlp_f_blk``, ``interpret``) have no counterpart.
Each plain version does its kernel's arithmetic step by step: LayerNorm
with fp32 statistics rounded to the compute dtype, products accumulated in
fp32 at the policy's precision (``layers.matmul``: under fp32's "high",
the 3-pass split), biases, activation and residual in fp32, one rounding
of each output (and of the MLP's hidden) to the compute dtype, which
under fp32 rounds nothing. The fp32 policies' GELU is the exact erf; the
TPU kernel's rational erf was a Mosaic workaround.

The wrappers run the plain versions only for tensors on the CPU (the
tests). On a CUDA tensor they launch the kernels or raise. Which kernels
run is the route of the operands' dtype and the policy's precision
(``route``, ``TMA_ROUTES``), every route on one TMA + wgmma engine: bf16
a row-statistics kernel and one GEMM with a LayerNorm or plain prologue
and a bias, activation or residual epilogue (``ln_linear`` is two
launches, ``linear_residual`` one, ``mlp_fused`` three, with its bf16
hidden through device memory); fp32 the same GEMM's split-plane modes on
the bf16 planes of its fp32 operands, under precision "high" (fp32_high)
the 3-pass mode on two planes and under "highest", the parity policy, the
6-pass mode on three (``ln_linear`` three launches, ``linear_residual``
two, ``mlp_fused`` four, counted apart in each wrapper's
``launches_3pass`` and ``launches_6pass``). None has a backward: an input
that requires grad while autograd records is refused.
"""

from __future__ import annotations

import functools

import torch

from aaclip_tpu_torch.core.config import DtypePolicy
from aaclip_tpu_torch.device import resolve_device
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.ops.attention import (KERNEL_HEAD_DIMS, TMA_ALIGN,
                                            attention_packed,
                                            attention_packed_vv)


def route(dtype: torch.dtype, precision) -> tuple:
    """The key of the fused_block.cu route that operands of ``dtype`` take
    under ``precision``, read as ``flash_attention.py::_kernel_precision``
    reads it: bf16 is single-pass whatever the precision (None); fp32 is
    3-pass under "high" and true fp32 otherwise ("highest")."""
    if dtype != torch.float32:
        return (dtype, None)
    return (dtype, "high" if precision == "high" else "highest")


BF16 = route(torch.bfloat16, None)
HIGH = route(torch.float32, "high")
FP32 = route(torch.float32, "highest")
# The routes on the TMA + wgmma engine of fused_block.cu: bf16
# (gemm_wgmma, row_stats_kernel) and fp32 on its split-plane modes
# (split_kernel, ln_split_kernel, gemm_planes_wgmma) with ``PLANES[key]``
# bf16 planes an operand: 2 under "high" (3-pass), 3 under "highest"
# (6-pass). ``_MODES`` are the entry points' ``mode`` codes (kModeF32,
# kModeBf16, kMode3Pass).
TMA_ROUTES = frozenset({BF16, HIGH, FP32})
PLANES = {HIGH: 2, FP32: 3}
_MODES = {FP32: 0, BF16: 1, HIGH: 2}
# The widths fused_block.cu takes: by route, the narrowest output tile and
# the reduction tile (N and K multiples of them); the largest LayerNorm row
# (the statistics hold it in registers).
_GEMM_TILES = {BF16: (128, 64), HIGH: (128, 64), FP32: (128, 64)}
KERNEL_MAX_K = 1024
_ACT_CODES = {L.gelu: 0, L.gelu_tanh: 1, L.quick_gelu: 2}  # fused_block.cu


def _ln_rows(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             cd: torch.dtype) -> torch.Tensor:
    """LayerNorm with fp32 statistics (the mean, then the mean of squared
    deviations), affine in fp32, rounded to ``cd`` (the TPU kernel's
    ``_ln_rows``)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + L._LN_EPS)
    return (y * weight.float() + bias.float()).to(cd)


def ln_linear_plain(x: torch.Tensor, ln_weight: torch.Tensor,
                    ln_bias: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    policy: DtypePolicy) -> torch.Tensor:
    """``layer_norm(x) @ w.T + b`` [.., F] in x's dtype: ``_ln_rows``, the
    product in fp32 at the policy's precision, + b in fp32, one rounding.
    ``w`` is [F, D]."""
    cd = policy.compute_dtype
    y = _ln_rows(x, ln_weight, ln_bias, cd)
    h = L.matmul(y, w.to(cd).t(), policy.precision) + b.float()
    return h.to(x.dtype)


def linear_residual_plain(res: torch.Tensor, y: torch.Tensor,
                          w: torch.Tensor, b: torch.Tensor,
                          policy: DtypePolicy) -> torch.Tensor:
    """``res + (y @ w.T + b)`` in fp32 (the product at the policy's
    precision), rounded once to res's dtype."""
    cd = policy.compute_dtype
    h = L.matmul(y.to(cd), w.to(cd).t(), policy.precision) + b.float()
    return (res.float() + h).to(res.dtype)


def mlp_fused_plain(x: torch.Tensor, ln_weight: torch.Tensor,
                    ln_bias: torch.Tensor, w_fc: torch.Tensor,
                    b_fc: torch.Tensor, w_proj: torch.Tensor,
                    b_proj: torch.Tensor, act,
                    policy: DtypePolicy) -> torch.Tensor:
    """``x + proj(act(fc(layer_norm(x))))``: ``_ln_rows``, fc + b_fc and
    ``act`` in fp32, the hidden rounded to the compute dtype (under fp32 it
    stays fp32), proj in fp32, then ``x + acc + b_proj`` in fp32, rounded
    once to x's dtype; both products at the policy's precision."""
    cd = policy.compute_dtype
    y = _ln_rows(x, ln_weight, ln_bias, cd)
    prec = policy.precision
    h = act(L.matmul(y, w_fc.to(cd).t(), prec) + b_fc.float())
    acc = L.matmul(h.to(cd), w_proj.to(cd).t(), prec)
    return (x.float() + acc + b_proj.float()).to(x.dtype)


@functools.cache
def _kernels():
    """The C entry points of ``csrc/fused_block.cu``, built on first use,
    with their argument types declared."""
    import ctypes

    from aaclip_tpu_torch.kernels.build import load

    lib = load("fused_block")
    i, p = ctypes.c_int, ctypes.c_void_p
    # x, w, bias, gamma, beta, mean, rstd, a_planes, w_planes, out, mode,
    # rows, n, k, stream
    lib.aaclip_ln_linear.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i,
                                     i, p]
    # res, y, w, bias, a_planes, w_planes, out, mode, rows, n, k, stream
    lib.aaclip_linear_residual.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                           p]
    # x, gamma, beta, w_fc, b_fc, w_proj, b_proj, mean, rstd, hidden,
    # a_planes, w_planes, out, mode, rows, d, f, act, stream
    lib.aaclip_mlp_fused.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p,
                                     i, i, i, i, i, p]
    lib.aaclip_gemm_tile_width.argtypes = [i]  # bn
    for fn in (lib.aaclip_ln_linear, lib.aaclip_linear_residual,
               lib.aaclip_mlp_fused, lib.aaclip_gemm_tile_width):
        fn.restype = i
    return lib


def _gemm_widths_ok(key: tuple, n: int, k: int, ln: bool = True) -> bool:
    """``tma_shape_ok``'s widths on route ``key``: n output columns, k
    reduced ones, under the LayerNorm prologue or not."""
    bn, bk = _GEMM_TILES[key]
    return n >= bn and n % bn == 0 and k >= bk and k % bk == 0 \
        and (not ln or k <= KERNEL_MAX_K)


def _mlp_widths_ok(key: tuple, d: int, f: int) -> bool:
    """``aaclip_mlp_fused``'s widths on route ``key``: model width d,
    hidden f, fc (LN, d -> f) and proj (f -> d) on the GEMM."""
    return _gemm_widths_ok(key, f, d) and _gemm_widths_ok(key, d, f,
                                                          ln=False)


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward (the fused block is "
                           f"inference-only); call it under no_grad or on "
                           f"tensors that do not require grad")


def _check_operands(name: str, policy: DtypePolicy, *tensors) -> None:
    """The kernels' preconditions on CUDA operands (x first): every one,
    the biases and LayerNorm affines too, already in the compute dtype (a
    tower pre-cast by ``core.params.cast_matmul_weights``, which casts a
    block's every leaf), so that a call launches its kernels and nothing
    else: no operand is cast or copied per call."""
    cd = policy.compute_dtype
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if cd not in (torch.bfloat16, torch.float32) \
            or any(t.dtype != cd for t in tensors):
        raise TypeError(f"{name}: every operand, vectors included, must be "
                        f"in the policy's compute dtype, bf16 or fp32 (got "
                        f"{cd}; pre-cast the tower with cast_matmul_weights)")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: operands must share the device")
        # the kernels copy 16-byte vectors; a tensor map's base is a
        # multiple of TMA_ALIGN bytes, its row stride (K * 2 bytes, K a
        # multiple of 64) too
        if not t.is_contiguous() or t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}: operands must be contiguous and "
                             f"{TMA_ALIGN}-byte aligned")


def _launch(name: str, entry, device: torch.device, *args) -> None:
    """Call a C entry point on ``device``'s current stream; raise on its
    CUDA error (cudaErrorInvalidValue for a shape with no instantiation).
    A null pointer is passed as None."""
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stats(x: torch.Tensor, key: tuple, rows: int) -> list:
    """The bf16 route's scratch on x's device, the rows' mean and rstd
    (fp32 [rows] each), or two None (null pointers) on the other routes.
    The caller keeps scratch until the launch is enqueued; after that the
    allocator may hand its memory on, in the stream's order."""
    if key != BF16:
        return [None, None]
    return [torch.empty(rows, dtype=torch.float32, device=x.device)
            for _ in range(2)]


def _planes(x: torch.Tensor, key: tuple, *shapes) -> list:
    """The split-plane routes' scratch on x's device: for each shape of
    ``shapes`` a bf16 tensor of ``PLANES[key]`` planes of it, or None (a
    null pointer) on the bf16 route."""
    if key not in PLANES:
        return [None] * len(shapes)
    return [torch.empty(PLANES[key], *shape, dtype=torch.bfloat16,
                        device=x.device) for shape in shapes]


def _count(wrapper, key: tuple) -> None:
    """One call of ``wrapper`` on route ``key``: ``launches`` counts every
    call, ``launches_3pass`` those of the 3-pass mode, ``launches_6pass``
    those of the 6-pass mode."""
    wrapper.launches += 1
    wrapper.launches_3pass += int(key == HIGH)
    wrapper.launches_6pass += int(key == FP32)


def _ptr(t) -> int | None:
    """A tensor's address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def ln_linear(x: torch.Tensor, ln_weight: torch.Tensor,
              ln_bias: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              policy: DtypePolicy = DtypePolicy()) -> torch.Tensor:
    """``layer_norm(x) @ w.T + b``: x [B, S, D], w [F, D] (nn.Linear's
    layout), b [F] -> [B, S, F] in x's dtype.

    CPU tensors take ``ln_linear_plain``. On CUDA tensors (all in the
    compute dtype, contiguous; D a multiple of 64 up to 1024 and F of 128)
    the kernels are launched on the current stream (bf16: the row
    statistics into two fp32 [rows] scratch vectors, then the GEMM; fp32:
    W's planes, the normalised rows' planes, then the 3-pass GEMM under
    "high" or the 6-pass one under "highest") and ``ln_linear.launches``
    counts each call (``launches_3pass`` and ``launches_6pass`` those on
    the split-plane routes)."""
    _refuse_grad("ln_linear", x, ln_weight, ln_bias, w, b)
    if x.device.type == "cpu":
        return ln_linear_plain(x, ln_weight, ln_bias, w, b, policy)
    _check_operands("ln_linear", policy, x, w, b, ln_weight, ln_bias)
    D = x.shape[-1]
    F = w.shape[0]
    if w.shape != (F, D) or b.shape != (F,) or ln_weight.shape != (D,) \
            or ln_bias.shape != (D,):
        raise ValueError("ln_linear: weight shapes do not match x")
    key = route(x.dtype, policy.precision)
    if not _gemm_widths_ok(key, F, D):
        raise ValueError(f"ln_linear: widths {D} -> {F} have no kernel "
                         f"instantiation on route {key}")
    R = x.numel() // D
    out = torch.empty(*x.shape[:-1], F, dtype=x.dtype, device=x.device)
    # the row statistics (bf16); the planes of the rows and of W (fp32)
    mean, rstd = _stats(x, key, R)
    a_planes, w_planes = _planes(x, key, (R, D), (F, D))
    _launch("ln_linear", _kernels().aaclip_ln_linear, x.device,
            x.data_ptr(), w.data_ptr(), b.data_ptr(), ln_weight.data_ptr(),
            ln_bias.data_ptr(), _ptr(mean), _ptr(rstd), _ptr(a_planes),
            _ptr(w_planes), out.data_ptr(), _MODES[key], R, F, D)
    _count(ln_linear, key)
    return out


ln_linear.launches = ln_linear.launches_3pass = ln_linear.launches_6pass = 0


def linear_residual(res: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor,
                    policy: DtypePolicy = DtypePolicy()) -> torch.Tensor:
    """``res + (y @ w.T + b)``: y [B, S, D_in], w [D, D_in], res [B, S,
    D] -> [B, S, D] in res's dtype.

    CPU tensors take ``linear_residual_plain``. On CUDA tensors (all in
    the compute dtype, contiguous; D_in a multiple of 64 and D of 128) the
    kernel is launched on the current stream (fp32 after one launch that
    splits W and y into their planes) and ``linear_residual.launches``
    counts each call (``launches_3pass`` and ``launches_6pass`` those on
    the split-plane routes)."""
    _refuse_grad("linear_residual", res, y, w, b)
    if res.device.type == "cpu":
        return linear_residual_plain(res, y, w, b, policy)
    _check_operands("linear_residual", policy, res, y, w, b)
    K, N = y.shape[-1], res.shape[-1]
    if (w.shape != (N, K) or b.shape != (N,)
            or y.shape[:-1] != res.shape[:-1]):
        raise ValueError("linear_residual: shapes do not match")
    key = route(res.dtype, policy.precision)
    if not _gemm_widths_ok(key, N, K, ln=False):
        raise ValueError(f"linear_residual: widths {K} -> {N} have no "
                         f"kernel instantiation on route {key}")
    R = res.numel() // N
    out = torch.empty_like(res)
    a_planes, w_planes = _planes(res, key, (R, K), (N, K))
    _launch("linear_residual", _kernels().aaclip_linear_residual, res.device,
            res.data_ptr(), y.data_ptr(), w.data_ptr(), b.data_ptr(),
            _ptr(a_planes), _ptr(w_planes), out.data_ptr(), _MODES[key], R,
            N, K)
    _count(linear_residual, key)
    return out


linear_residual.launches = linear_residual.launches_3pass = \
    linear_residual.launches_6pass = 0


def mlp_fused(x: torch.Tensor, ln_weight: torch.Tensor,
              ln_bias: torch.Tensor, w_fc: torch.Tensor, b_fc: torch.Tensor,
              w_proj: torch.Tensor, b_proj: torch.Tensor, act,
              policy: DtypePolicy = DtypePolicy()) -> torch.Tensor:
    """``x + proj(act(fc(layer_norm(x))))``: x [B, S, D], w_fc [F, D],
    w_proj [D, F] -> [B, S, D] in x's dtype; ``act`` is ``layers.gelu``,
    ``gelu_tanh`` or ``quick_gelu``.

    CPU tensors take ``mlp_fused_plain``. On CUDA tensors (all in the
    compute dtype, contiguous; D a multiple of 128 up to 1024, F of 128)
    the kernels are launched on the current stream and
    ``mlp_fused.launches`` counts each call (``launches_3pass`` and
    ``launches_6pass`` those on the split-plane routes).

    bf16 is three launches: the
    row statistics, fc with the LayerNorm prologue and the activation
    epilogue into a bf16 [rows, F] hidden, and proj with the ``(x + acc) +
    b_proj`` epilogue. The hidden goes through device memory as bf16, 359
    MB at the predict's batch 32 (43,840 rows of F 4096), allocated here:
    a block that kept it on chip would have to hold the full-width
    [rows, D] fp32 accumulator, at most ~40 rows in the SM's 256 KB of
    registers, and read both weight matrices (16.8 MB at D 1024) for them,
    while each half alone is bound by the tensor cores (fc 367.8 GFLOP
    against 90 MB of x, 8.4 MB of W_fc and 359 MB of hidden, proj the
    same), so writing and reading the hidden (718 MB, ~0.21 ms at 3.35
    TB/s) hides under ~0.74 ms of tensor-core time. The TPU kernel and the
    plain version round the hidden to bf16 at that point, so the numerics
    are the same. fp32 is four launches: the planes of both weights, the
    normalised rows' planes, fc with the activation epilogue writing the
    fp32 hidden's planes [P, rows, F] (P = 2 under "high", as much memory
    as the fp32 hidden; 3 under "highest"), and proj on them, in the 3-pass
    or the 6-pass mode."""
    _refuse_grad("mlp_fused", x, ln_weight, ln_bias, w_fc, b_fc, w_proj,
                 b_proj)
    if x.device.type == "cpu":
        return mlp_fused_plain(x, ln_weight, ln_bias, w_fc, b_fc, w_proj,
                               b_proj, act, policy)
    if act not in _ACT_CODES:
        raise ValueError(f"mlp_fused: activation {act} has no kernel "
                         f"(have gelu, gelu_tanh, quick_gelu)")
    _check_operands("mlp_fused", policy, x, ln_weight, ln_bias, w_fc, b_fc,
                    w_proj, b_proj)
    D = x.shape[-1]
    F = w_fc.shape[0]
    if (w_fc.shape != (F, D) or w_proj.shape != (D, F) or b_fc.shape != (F,)
            or b_proj.shape != (D,) or ln_weight.shape != (D,)
            or ln_bias.shape != (D,)):
        raise ValueError("mlp_fused: weight shapes do not match x")
    key = route(x.dtype, policy.precision)
    if not _mlp_widths_ok(key, D, F):
        raise ValueError(
            f"mlp_fused: width {D}, hidden {F} have no kernel on route {key}"
            f" (width a multiple of {_GEMM_TILES[key][0]} up to "
            f"{KERNEL_MAX_K}, hidden of {_GEMM_TILES[key][0]})")
    R = x.numel() // D
    out = torch.empty_like(x)
    # bf16: the statistics and the bf16 hidden; fp32: the hidden's, the
    # normalised rows' and both weights' planes
    mean, rstd = _stats(x, key, R)
    hidden, a_planes, w_planes = _planes(x, key, (R, F), (R, D), (2 * F, D))
    if key == BF16:
        hidden = torch.empty(R, F, dtype=torch.bfloat16, device=x.device)
    _launch("mlp_fused", _kernels().aaclip_mlp_fused, x.device,
            x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(),
            w_fc.data_ptr(),
            b_fc.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(),
            _ptr(mean), _ptr(rstd), _ptr(hidden), _ptr(a_planes),
            _ptr(w_planes), out.data_ptr(), _MODES[key], R, D, F,
            _ACT_CODES[act])
    _count(mlp_fused, key)
    return out


mlp_fused.launches = mlp_fused.launches_3pass = mlp_fused.launches_6pass = 0


def gemm_tile_width(bn: int) -> None:
    """Make every later bf16 GEMM launch take output tiles of ``bn``
    columns, 128 or 256 (a launch whose width 256 does not divide then
    raises), or ``fused_block.cu``'s own choice again with 0: for timing
    the two widths against each other on the card. Builds the kernels on
    first use."""
    if _kernels().aaclip_gemm_tile_width(bn) != 0:
        raise ValueError(f"gemm_tile_width: no tile of {bn} columns "
                         f"(have 0, 128, 256)")


def make_block_fn(num_heads: int, policy: DtypePolicy = DtypePolicy(), *,
                  act, vv: bool = False, ln=ln_linear, attention=None,
                  residual=linear_residual, mlp=mlp_fused):
    """``block_fn`` (``vv_block_fn`` with ``vv``) for
    ``models/layers.residual_block``: receives the block's un-normalised
    residual stream and its ``ResidualBlock``, returns the block output:
    ``ln`` (QKV, or only the value third of ``in_proj_weight`` with
    ``vv``) -> ``attention`` -> ``residual`` (out-projection) -> ``mlp``.
    Inference only.

    The ops default to the kernel wrappers (``attention``:
    ``attention_packed``, or ``attention_packed_vv`` with ``vv``); the
    ``*_plain`` versions give the same block with the plain arithmetic on
    any device (the on-card comparison). ``attention`` gets the policy's
    precision, as JAX's block passes it, so under fp32_high (fp32, "high")
    every op of the block runs its kernels' 3-pass mode, and under fp32
    ("highest") their 6-pass mode. The block closes
    over ``policy`` and runs it on every block it is given, the staged
    prefix of an fp32_high trunk included, as JAX's does."""
    if attention is None:
        attention = attention_packed_vv if vv else attention_packed

    def block_fn(x: torch.Tensor, blk: L.ResidualBlock) -> torch.Tensor:
        D = x.shape[-1]
        a = blk.attn
        w, b = a.in_proj_weight, a.in_proj_bias
        if vv:
            w, b = w[2 * D:], b[2 * D:]
        packed = ln(x, blk.ln_1.weight, blk.ln_1.bias, w, b, policy)
        out = attention(packed, num_heads, x.shape[1],
                        precision=policy.precision)
        x = residual(x, out, a.out_proj.weight, a.out_proj.bias, policy)
        m = blk.mlp
        return mlp(x, blk.ln_2.weight, blk.ln_2.bias, m.c_fc.weight,
                   m.c_fc.bias, m.c_proj.weight, m.c_proj.bias, act, policy)

    return block_fn


def fused_block_supported(cfg, policy: DtypePolicy) -> bool:
    """Whether the kernels are instantiated for ``cfg``'s vision tower
    under ``policy``, by the wrappers' own width checks: the packed
    attention's head dim, the QKV projection, the V-V value third and the
    out-projection as GEMMs, and the MLP."""
    v = cfg.vision
    key = route(policy.compute_dtype, policy.precision)
    return (key in _GEMM_TILES and v.head_dim in KERNEL_HEAD_DIMS
            and _gemm_widths_ok(key, 3 * v.width, v.width)
            and _gemm_widths_ok(key, v.width, v.width, ln=False)
            and _mlp_widths_ok(key, v.width, int(v.width * v.mlp_ratio)))


def reference_gate(cfg) -> bool:
    """The JAX package's gate on ``cfg``'s vision tower
    (``aaclip_tpu/ops/fused_block.py::fused_block_supported``): the
    geometry its Pallas kernels tile, i.e. the packed attention's
    (``flash_attention.py::pallas_attention_supported``: two heads a block
    when the count is even, one otherwise, their columns a multiple of
    128) and model and MLP widths that are multiples of 128. ViT-H-14's 16
    heads of 80 fail it; ViT-L's 16 of 64 and 8 of 128 pass."""
    v = cfg.vision
    heads_per_blk = 2 if v.heads % 2 == 0 else 1
    return ((heads_per_blk * (v.width // v.heads)) % 128 == 0
            and v.width % 128 == 0 and int(v.width * v.mlp_ratio) % 128 == 0)


def maybe_make_block_fn(cfg, policy: DtypePolicy, *, vv: bool = False,
                        device=None):
    """The fused block for ``cfg`` on the card under the bf16 policy, where
    the JAX package's gate admits the geometry (``reference_gate``); None
    off the card (the JAX package's "not the kernel backend"), where that
    gate refuses the geometry (ViT-H-14's head dim 80), and under every
    other policy (int8 included): the caller keeps the unfused block. As
    JAX's gate, it gives None for every policy but bf16 so that the fp32
    parity paths keep their numerics: a caller under fp32 is asking for
    the parity path, not for the fused kernels (which ``make_block_fn``
    still builds in fp32 when asked directly). On the card a bf16 geometry
    that JAX's gate admits and the kernels do not take raises, naming the
    widths (``fused_block_supported``: the LayerNorm GEMMs reduce at most
    ``KERNEL_MAX_K`` columns). ``device=None`` means the card and raises
    without one."""
    if resolve_device(device).type != "cuda":
        return None
    if not reference_gate(cfg):
        return None
    if policy.compute_dtype != torch.bfloat16:
        return None
    if policy.quant_int8:
        # int8 rides bf16 compute too, but the fused kernels read float
        # weights: int8 codes without their scales would compute garbage
        return None
    if not fused_block_supported(cfg, policy):
        v = cfg.vision
        raise ValueError(
            f"the fused block has no kernels for width {v.width} (QKV "
            f"{3 * v.width} columns, MLP {int(v.width * v.mlp_ratio)}), head "
            f"dim {v.head_dim} under {policy.compute_dtype}: the LayerNorm "
            f"GEMMs reduce at most {KERNEL_MAX_K} columns and the GEMMs "
            f"take widths in multiples of their tiles "
            f"{_GEMM_TILES[route(policy.compute_dtype, policy.precision)]}")
    return make_block_fn(cfg.vision.heads, policy,
                         act=L.config_act(cfg, policy), vv=vv)

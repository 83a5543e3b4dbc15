"""Packed attention: the wrappers around the hand-written CUDA kernels
(``kernels/csrc/attention_packed.cu`` forward, in its standard and V-V
modes and on the ``[B, H, S, hd]`` layout, ``kernels/csrc/
attention_packed_bwd.cu`` backward), their plain PyTorch versions, the
differentiable form, and the ``attn_fn`` hook that puts them into the
residual blocks.

They replace ``aaclip_tpu/ops/flash_attention.py``'s ``attention_packed``
and ``attention_packed_diff``: softmax attention read straight out of the
packed projection ``qkv [B, S, 3*D]`` (bias already added), keys at or
past ``valid_len`` masked, written token-major ``[B, S, D]`` for the
out-projection, and its backward into ``d(qkv)``. The V-V mode
(``vv=True, packed_sections=1``, CLIP-Surgery) reads a value-only
projection ``v [B, S, D]`` as q, k and v: the same kernel with all three
section offsets at 0 and the row stride D. ``attention_kernel`` replaces
``flash_attention.py``'s ``attention_kernel``, the same function on
separate q, k, v in ``[B, H, S, hd]``: the same kernel again, launched with
that layout's strides.

The wrappers run the plain versions only for tensors on the CPU (the
tests). On a CUDA tensor they launch the kernel or raise. Which kernel
runs is ``kernel_route`` over the route table ``TMA_ROUTES``: at head dims
64, 80, 88, 104 and 128 (``TMA_HEAD_DIMS``, the forward's and the
backward's alike) bf16 takes the TMA + wgmma kernels, and fp32 the
6-pass kernels on the same machinery (tiles fed by tensor maps, whose base
addresses, head and row strides must be multiples of ``TMA_ALIGN`` bytes:
the wrappers refuse what a map cannot take); head dim 16 keeps the first
port's mma.sync (bf16) and FMA (fp32) kernels in the same sources.

Precision. Every wrapper and plain version takes the JAX package's
``precision``, as its kernels do through ``_kdot``. fp32 inputs under
"highest" or None (the CLIs' default ``--precision fp32``) are the TPU's
native 6-pass form on the card: ``split3`` writes each fp32 operand's
bf16 planes hi, mid and lo (hi + mid + lo = x), and every product is the
six bf16 products hi·hi + hi·mid + mid·hi + hi·lo + lo·hi + mid·mid summed
in fp32 (the ``*_6pass`` entry points of both sources, TMA + wgmma on the
planes; P and dS stay fp32 and are split in registers), counted in each
wrapper's ``launches_6pass``. The plain versions compute those in true
fp32: the dropped terms are about 2^-24 relative. fp32 inputs under
"high" run the 3-pass mode (``_three_pass``), each product as three bf16
products hi·hi + hi·lo + lo·hi of the operands' bf16 halves summed in fp32
(XLA's F32_AS_3BF16), the softmax and P in fp32 and P split too, never
rounded. On the card that mode is its own kernels (the ``*_3pass`` entry
points of both sources: mma.sync bf16 tensor-core products from hi/lo
tiles at head dim 16; at the TMA head dims the ``*_3pass_wgmma`` entry
points, the 6-pass route's TMA + wgmma machinery on the two planes hi and
lo that ``split2`` writes, with three bf16 products per product), counted
in ``launches_3pass``. ``launches`` counts every launch. bf16 inputs
ignore the precision, as ``_kernel_precision`` does.
"""

from __future__ import annotations

import functools

import torch

from aaclip_tpu_torch.core.config import DtypePolicy
from aaclip_tpu_torch.models.layers import (_split_bf16, enter, linear,
                                            local_heads, qkv_params,
                                            row_linear)

# head dims the forward is built for: tiny-test's 16, ViT-L's 64,
# open_clip's ViT-H-14 (80), ViT-g-14 (88) and ViT-bigG-14 (104), and 128
KERNEL_HEAD_DIMS = (16, 64, 80, 88, 104, 128)
# the head dims of the forward's TMA + wgmma kernels (tma_head_dim of
# attention_packed.cu)
TMA_HEAD_DIMS = (64, 80, 88, 104, 128)
# (dtype, head dim) pairs on the forward's TMA + wgmma kernels: bf16
# directly, fp32 on its bf16 planes (three on the 6-pass route, two on the
# 3-pass one); every other pair of (bf16, fp32) x KERNEL_HEAD_DIMS runs a
# retained kernel.
TMA_ROUTES = frozenset((dtype, hd) for dtype in (torch.bfloat16,
                                                 torch.float32)
                       for hd in TMA_HEAD_DIMS)
# the backward's head dims, the forward's: the retained kernels' 16 and the
# TMA + wgmma pairs' 64, 80, 88, 104 and 128 (tma_head_dim of
# attention_packed_bwd.cu)
BWD_HEAD_DIMS = KERNEL_HEAD_DIMS
TMA_ALIGN = 16  # bytes: a tensor map's base address and strides (kTmaAlign)


def _tma_misaligned(*addresses: int) -> bool:
    """Whether any base address or stride, in bytes, is one a TMA tensor
    map cannot take."""
    return any(a % TMA_ALIGN for a in addresses)


def _three_pass(dtype: torch.dtype, precision) -> bool:
    """Whether inputs of ``dtype`` run the 3-pass mode under ``precision``
    (``flash_attention.py::_kernel_precision``: "high" for 4-byte inputs;
    bf16 inputs always run single-pass)."""
    return dtype == torch.float32 and precision == "high"


def kernel_route(dtype: torch.dtype, head_dim: int, precision) -> str:
    """The kernel a CUDA launch of ``dtype`` operands at ``head_dim`` runs
    under ``precision``: "wgmma" (bf16 on ``TMA_ROUTES``), "6pass" (fp32 on
    ``TMA_ROUTES``: TMA + wgmma on the ``split3`` planes), "3pass_wgmma"
    (fp32 on ``TMA_ROUTES`` under "high": the same on the ``split2``
    planes), "3pass" (fp32 otherwise under "high": mma.sync from hi/lo
    tiles), "mma" (bf16 otherwise) or "fma" (fp32 otherwise). Every
    wrapper launches by it."""
    tma = (dtype, head_dim) in TMA_ROUTES
    if _three_pass(dtype, precision):
        return "3pass_wgmma" if tma else "3pass"
    bf16 = dtype == torch.bfloat16
    if tma:
        return "wgmma" if bf16 else "6pass"
    return "mma" if bf16 else "fma"


# the routes whose kernels read bf16 tensor maps: of the operands
# themselves (wgmma) or of their split planes (the others)
MAP_ROUTES = ("wgmma", "6pass", "3pass_wgmma")


def _bwd_workspace(tiles: int, batch: int, heads: int, head_dim: int,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """The key-outer kernel's workspace for ``tiles`` 64-row query tiles
    (``_bwd_workspace_tiles``): ``dq_acc``, dQ's fp32 sum over the key
    blocks so far, ``[B, H, tiles * 64, hd]`` (each chain's first key
    block writes it), and ``counters``, int32, one per (image, head, query
    tile) (the key block whose turn it is to add), then the persistent
    grid's ticket; both ``torch.empty``: the dsum pre-pass zeroes the
    counters. Allocated per call, so no call finds another's counts."""
    return (torch.empty(batch, heads, tiles * 64, head_dim,
                        dtype=torch.float32, device=device),
            torch.empty(batch * heads * tiles + 1, dtype=torch.int32,
                        device=device))


def split3_plain(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` as its three bf16 planes ``[3, *x.shape]``: hi = bf16(x),
    mid = bf16(x - hi), lo = bf16(x - hi - mid), each difference exact in
    fp32, so hi + mid + lo = x for |x| in [2^-110, 0x1.fep127) (below,
    lo drops bits under bf16's subnormal step 2^-133; above, hi rounds to
    inf). The 6-pass route's operand staging: ``split3`` and the tests."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return torch.stack([hi, mid, (r - mid.float()).to(torch.bfloat16)])


def split2_plain(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` as its two bf16 planes ``[2, *x.shape]``: hi = bf16(x),
    lo = bf16(x - hi), ``models/layers.py::_split_bf16``'s halves and
    planes 0 and 1 of ``split3_plain``. The 3-pass route's operand
    staging: ``split2`` and the tests."""
    return torch.stack(_split_bf16(x))


@functools.cache
def _split_kernel(planes: int):
    """``aaclip_split3`` (three planes) or ``aaclip_split2`` (two) of
    ``csrc/attention_packed.cu``."""
    import ctypes

    from aaclip_tpu_torch.kernels.build import load

    split = getattr(load("attention_packed"), f"aaclip_split{planes}")
    ll, p = ctypes.c_longlong, ctypes.c_void_p
    split.argtypes = [p, p, ll, ll, p]  # x, planes, n, plane stride, stream
    split.restype = ctypes.c_int
    return split


def _split_planes(wrapper, x: torch.Tensor, planes: int) -> torch.Tensor:
    """The split kernel of ``planes`` planes on a CUDA ``x`` (contiguous,
    16-byte aligned): the planes in one new tensor (plane stride
    ``x.numel()`` rounded up to 8), written on the current stream, each
    launch counted in ``wrapper.launches``."""
    name = wrapper.__name__
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"{name}: need an fp32 CUDA tensor, got {x.dtype} "
                         f"on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: input must be contiguous and 16-byte "
                         "aligned")
    n = x.numel()
    stride = -(-n // 8) * 8
    out = torch.empty(planes, stride, dtype=torch.bfloat16, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            rc = _split_kernel(planes)(
                x.data_ptr(), out.data_ptr(), n, stride,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{rc}")
        wrapper.launches += 1
    return out[:, :n].view(planes, *x.shape)


def split3(x: torch.Tensor) -> torch.Tensor:
    """``split3_plain``'s planes ``[3, *x.shape]`` bf16 of an fp32 ``x``.

    CPU tensors take ``split3_plain``. A CUDA tensor must be contiguous
    and 16-byte aligned; ``split3_kernel`` writes the planes into one new
    tensor and ``split3.launches`` counts each launch."""
    if x.device.type == "cpu":
        return split3_plain(x)
    return _split_planes(split3, x, 3)


def split2(x: torch.Tensor) -> torch.Tensor:
    """``split2_plain``'s planes ``[2, *x.shape]`` bf16 of an fp32 ``x``.

    CPU tensors take ``split2_plain``. A CUDA tensor must be contiguous
    and 16-byte aligned; ``split2_kernel`` writes the planes into one new
    tensor and ``split2.launches`` counts each launch."""
    if x.device.type == "cpu":
        return split2_plain(x)
    return _split_planes(split2, x, 2)


split3.launches = split2.launches = 0


def _kdot(a: torch.Tensor, b: torch.Tensor, three_pass: bool) -> torch.Tensor:
    """``a @ b`` of fp32 tensors holding the kernel's operands: plain fp32,
    or with ``three_pass`` as ``_kdot``'s "high" branch computes it, the
    bf16 halves' products hi·hi + hi·lo + lo·hi summed in fp32 in that
    order (each product exact in fp32)."""
    if not three_pass:
        return torch.matmul(a, b)
    ah, al = (t.float() for t in _split_bf16(a))
    bh, bl = (t.float() for t in _split_bf16(b))
    return torch.matmul(ah, bh) + torch.matmul(ah, bl) + torch.matmul(al, bh)


def _split(x: torch.Tensor, num_heads: int, sections: int = 3):
    """(B, S, D, head_dim, scale, (q_off, k_off, v_off)) of a packed
    [B, S, sections*D] projection, offsets in elements: q, k and v of a
    three-section qkv, or all three on the one section of a value-only
    projection (V-V)."""
    B, S, width = x.shape
    if width % sections or (width // sections) % num_heads:
        raise ValueError(f"packed width {width} does not split into "
                         f"{sections} section(s) of {num_heads} heads")
    dm = width // sections
    hd = dm // num_heads
    offs = (0, dm, 2 * dm) if sections == 3 else (0, 0, 0)
    return B, S, dm, hd, hd ** -0.5, offs


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid_len: int, dtype: torch.dtype,
            precision=None) -> torch.Tensor:
    """The forward kernel's arithmetic in plain PyTorch on fp32 [B, H, S,
    hd] heads holding ``dtype`` values: fp32 scores, mask, max-subtract,
    exp, fp32 row sum, P cast to ``dtype``, P.V in fp32, one division at
    the end; fp32 out. In the 3-pass mode both products are ``_kdot``'s
    three bf16 products and P stays fp32 (split, not rounded).
    Materialises [B, H, S, S]."""
    S, hd = q.shape[-2:]
    three = _three_pass(dtype, precision)
    s = _kdot(q, k.transpose(-1, -2), three) * hd ** -0.5
    if valid_len < S:
        s[..., valid_len:] = float("-inf")
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    l = p.sum(-1, keepdim=True)
    return _kdot(p.to(dtype).float(), v, three) / l


def _plain(x: torch.Tensor, num_heads: int, valid_len: int,
           sections: int, precision) -> torch.Tensor:
    """``_attend`` on the heads of a packed projection, written
    token-major [B, S, D] in its dtype."""
    B, S, dm, hd, _, offs = _split(x, num_heads, sections)

    def heads(off):
        sec = x[..., off:off + dm].reshape(B, S, num_heads, hd)
        return sec.transpose(1, 2).float()

    q, k, v = (heads(off) for off in offs)
    o = _attend(q, k, v, valid_len, x.dtype, precision)
    return o.transpose(1, 2).reshape(B, S, dm).to(x.dtype)


def attention_packed_plain(qkv: torch.Tensor, num_heads: int,
                           valid_len: int, *,
                           precision=None) -> torch.Tensor:
    """``attention_packed``'s kernel arithmetic (``_plain``) on a packed
    [B, S, 3*D] qkv."""
    return _plain(qkv, num_heads, valid_len, 3, precision)


def attention_packed_vv_plain(v: torch.Tensor, num_heads: int,
                              valid_len: int, *,
                              precision=None) -> torch.Tensor:
    """``attention_packed_vv``'s kernel arithmetic (``_plain``) on a
    value-only [B, S, D]: softmax(V V^T hd^-1/2) V per head."""
    return _plain(v, num_heads, valid_len, 1, precision)


def attention_kernel_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid_len: int, *,
                           precision=None) -> torch.Tensor:
    """``attention_kernel``'s arithmetic (``_attend``) on separate [B, H,
    S, hd] q, k, v; returns [B, H, S, hd] in q's dtype. Keys at or past
    ``valid_len`` are masked; every row is a query."""
    o = _attend(q.float(), k.float(), v.float(), valid_len, q.dtype,
                precision)
    return o.to(q.dtype)


def attention_packed_bwd_plain(qkv: torch.Tensor, d_out: torch.Tensor,
                               num_heads: int, valid_len: int, *,
                               precision=None) -> torch.Tensor:
    """``d(qkv)`` [B, S, 3*D] in qkv's dtype, step by step as
    ``_packed_bwd_kernel`` computes it: dO cast to the input dtype; fp32
    scores, mask, max-subtract, exp and normalise to P in fp32;
    dV = round(P)^T dO and dP = dO V^T in fp32; dsum = rowsum(dP * P);
    dS = P * (dP - dsum) * scale rounded to the input dtype; dQ = dS K cast
    to the input dtype; dK = dS^T Q. Every product accumulates in fp32 (the
    rounded operands are exact in fp32) and dK, dV are cast at the end. In
    the 3-pass mode (fp32 under "high") each of the five products is
    ``_kdot``'s three bf16 products, with dO, P and dS fp32 (split, never
    rounded). Materialises several [B, H, S, S] fp32 tensors."""
    B, S, dm, hd, scale, offs = _split(qkv, num_heads)
    dt = qkv.dtype
    three = _three_pass(dt, precision)

    def heads(t):
        return t.reshape(B, S, num_heads, hd).transpose(1, 2).float()

    q, k, v = (heads(qkv[..., off:off + dm]) for off in offs)
    do = heads(d_out.to(dt))
    s = _kdot(q, k.transpose(-1, -2), three) * scale
    if valid_len < S:
        s[..., valid_len:] = float("-inf")
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dv = _kdot(p.to(dt).float().transpose(-1, -2), do, three)
    dp = _kdot(do, v.transpose(-1, -2), three)
    dsum = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - dsum) * scale).to(dt).float()
    dq = _kdot(ds, k, three)
    dk = _kdot(ds.transpose(-1, -2), q, three)
    return torch.cat([g.to(dt).transpose(1, 2).reshape(B, S, dm)
                      for g in (dq, dk, dv)], dim=-1)


def _check_cuda(name: str, x: torch.Tensor, num_heads: int,
                valid_len: int, sections: int = 3, precision=None):
    """The kernels' preconditions on a packed projection; returns
    ``_split(x, num_heads, sections)`` and the ``kernel_route``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    split = _split(x, num_heads, sections)
    B, S, _, hd, _, _ = split
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {x.dtype} is not bf16 or fp32")
    # the kernel copies 16-byte vectors from each row and head
    if (not x.is_contiguous() or x.data_ptr() % 16
            or (x.shape[-1] * x.element_size()) % 16):
        raise ValueError(f"{name}: input must be contiguous, 16-byte "
                         f"aligned, with rows a multiple of 16 bytes")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} has no kernel "
                         f"instantiation (have {KERNEL_HEAD_DIMS})")
    if B < 1 or not 1 <= valid_len <= S:
        raise ValueError(f"{name}: need batch >= 1 and 1 <= valid_len <= S,"
                         f" got B={B}, valid_len={valid_len}, S={S}")
    route = kernel_route(x.dtype, hd, precision)
    # the tensor maps read bf16: x itself on the wgmma route, its split
    # planes on the plane routes (a new tensor, whose planes are aligned
    # when the row stride is); at 88 and 104 one head is a map row
    base = x.data_ptr() if route == "wgmma" else 0
    if route in MAP_ROUTES and _tma_misaligned(
            x.shape[-1] * 2, hd * 2, *(base + o * 2 for o in split[-1])):
        raise ValueError(f"{name}: a section start, the head or the row "
                         f"stride is not a multiple of {TMA_ALIGN} bytes "
                         f"(TMA)")
    return split, route


@functools.cache
def _kernel():
    """The C entry point of ``csrc/attention_packed.cu``, built on first
    use, with its argument types declared."""
    import ctypes

    from aaclip_tpu_torch.kernels.build import load

    fn = load("attention_packed").aaclip_attention_packed
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    # qkv, out, lse, bf16, head_dim, batch, seq, valid_len, heads, ld,
    # q_off, k_off, v_off, out_ld, scale, stream
    fn.argtypes = [p, p, p, i, i, i, i, i, i, ll, i, i, i, ll,
                   ctypes.c_float, p]
    fn.restype = i
    return fn


@functools.cache
def _bhsd_kernel():
    """``aaclip_attention_bhsd`` of ``csrc/attention_packed.cu``: the
    forward kernel on the [B, H, S, hd] layout."""
    import ctypes

    from aaclip_tpu_torch.kernels.build import load

    fn = load("attention_packed").aaclip_attention_bhsd
    i, p = ctypes.c_int, ctypes.c_void_p
    # q, k, v, out, bf16, head_dim, batch, seq, valid_len, heads, scale,
    # stream
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    return fn


@functools.cache
def _bwd_kernel():
    """The C entry point of ``csrc/attention_packed_bwd.cu``, built on
    first use, with its argument types declared."""
    import ctypes

    from aaclip_tpu_torch.kernels.build import load

    fn = load("attention_packed_bwd").aaclip_attention_packed_bwd
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    # qkv, d_out, lse, dsum, d_qkv, dq_acc, counters, bf16, head_dim, batch,
    # seq, valid_len, heads, ld, q_off, k_off, v_off, do_ld, scale, stream
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, ll, i, i, i, ll,
                   ctypes.c_float, p]
    fn.restype = i
    return fn


@functools.cache
def _bwd_workspace_tiles():
    """``aaclip_attention_packed_bwd_workspace(bf16, head_dim, seq)`` of
    ``csrc/attention_packed_bwd.cu``: the query tiles of the workspace the
    bf16 entry point takes for such a call (the key-outer plan's), 0 where
    its kernels read none. The source alone picks the plan."""
    import ctypes

    from aaclip_tpu_torch.kernels.build import load

    fn = load("attention_packed_bwd").aaclip_attention_packed_bwd_workspace
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernels_6pass():
    """The 6-pass entry points of both sources (fp32 at the TMA head dims
    on the ``split3`` planes), built on first use: ``(packed forward, [B,
    H, S, hd] forward, packed backward)``."""
    import ctypes

    from aaclip_tpu_torch.kernels.build import load

    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fwd = load("attention_packed").aaclip_attention_packed_6pass
    # planes, out, lse, head_dim, batch, seq, valid_len, heads, ld, q_off,
    # k_off, v_off, out_ld, scale, stream
    fwd.argtypes = [p, p, p, i, i, i, i, i, ll, i, i, i, ll,
                    ctypes.c_float, p]
    bhsd = load("attention_packed").aaclip_attention_bhsd_6pass
    # q planes, k planes, v planes, out, head_dim, batch, seq, valid_len,
    # heads, scale, stream
    bhsd.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    bwd = load("attention_packed_bwd").aaclip_attention_packed_bwd_6pass
    # qkv planes, d_out planes, lse, dsum, d_qkv, head_dim, batch, seq,
    # valid_len, heads, ld, q_off, k_off, v_off, do_ld, scale, stream
    bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, i, i, i, ll,
                    ctypes.c_float, p]
    for fn in (fwd, bhsd, bwd):
        fn.restype = i
    return fwd, bhsd, bwd


@functools.cache
def _kernels_3pass():
    """The 3-pass entry points of both sources (fp32 only), built on first
    use: ``(packed forward, [B, H, S, hd] forward, packed backward)``."""
    import ctypes

    from aaclip_tpu_torch.kernels.build import load

    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fwd = load("attention_packed").aaclip_attention_packed_3pass
    # qkv, out, lse, head_dim, batch, seq, valid_len, heads, ld, q_off,
    # k_off, v_off, out_ld, scale, stream
    fwd.argtypes = [p, p, p, i, i, i, i, i, ll, i, i, i, ll,
                    ctypes.c_float, p]
    bhsd = load("attention_packed").aaclip_attention_bhsd_3pass
    # q, k, v, out, head_dim, batch, seq, valid_len, heads, scale, stream
    bhsd.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    bwd = load("attention_packed_bwd").aaclip_attention_packed_bwd_3pass
    # qkv, d_out, lse, dsum, d_qkv, head_dim, batch, seq, valid_len, heads,
    # ld, q_off, k_off, v_off, do_ld, scale, stream
    bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, i, i, i, ll,
                    ctypes.c_float, p]
    for fn in (fwd, bhsd, bwd):
        fn.restype = i
    return fwd, bhsd, bwd


@functools.cache
def _kernels_3pass_wgmma():
    """The 3-pass entry points at the TMA head dims (fp32 under "high" on
    the ``split2`` planes), built on first use: ``(packed forward, [B, H,
    S, hd] forward, packed backward)``, with the 6-pass entries'
    signatures."""
    import ctypes

    from aaclip_tpu_torch.kernels.build import load

    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fwd = load("attention_packed").aaclip_attention_packed_3pass_wgmma
    # planes, out, lse, head_dim, batch, seq, valid_len, heads, ld, q_off,
    # k_off, v_off, out_ld, scale, stream
    fwd.argtypes = [p, p, p, i, i, i, i, i, ll, i, i, i, ll,
                    ctypes.c_float, p]
    bhsd = load("attention_packed").aaclip_attention_bhsd_3pass_wgmma
    # q planes, k planes, v planes, out, head_dim, batch, seq, valid_len,
    # heads, scale, stream
    bhsd.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    bwd = load("attention_packed_bwd").aaclip_attention_packed_bwd_3pass_wgmma
    # qkv planes, d_out planes, lse, dsum, d_qkv, head_dim, batch, seq,
    # valid_len, heads, ld, q_off, k_off, v_off, do_ld, scale, stream
    bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, i, i, i, ll,
                    ctypes.c_float, p]
    for fn in (fwd, bhsd, bwd):
        fn.restype = i
    return fwd, bhsd, bwd


def _planes(route: str, x: torch.Tensor) -> torch.Tensor:
    """The split planes a plane route's kernels read: ``split3``'s on the
    6-pass route, ``split2``'s on the 3-pass one."""
    return split3(x) if route == "6pass" else split2(x)


def _count(wrapper, route: str) -> None:
    """One launch of ``wrapper``'s kernel on ``route``: ``launches``
    counts every launch, ``launches_3pass`` and ``launches_6pass`` those
    of the two fp32 tensor-core modes (the 3-pass mode on either of its
    routes)."""
    wrapper.launches += 1
    wrapper.launches_3pass += int(route in ("3pass", "3pass_wgmma"))
    wrapper.launches_6pass += int(route == "6pass")


def _launch_forward(name: str, x: torch.Tensor, num_heads: int,
                    valid_len: int, sections: int, return_lse: bool,
                    precision):
    """Launch the forward kernel of ``kernel_route`` on a packed [B, S,
    sections*D] projection on the current stream; returns ``(out, lse or
    None, route)``."""
    (B, S, dm, hd, scale, (q_off, k_off, v_off)), route = _check_cuda(
        name, x, num_heads, valid_len, sections, precision)
    out = torch.empty(B, S, dm, dtype=x.dtype, device=x.device)
    lse = (torch.empty(B, num_heads, S, dtype=torch.float32,
                       device=x.device) if return_lse else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (hd, B, S, valid_len, num_heads, sections * dm, q_off, k_off,
                v_off, dm, scale, stream)
        lse_ptr = lse.data_ptr() if return_lse else None
        if route == "3pass":
            rc = _kernels_3pass()[0](x.data_ptr(), out.data_ptr(), lse_ptr,
                                     *args)
        elif route in ("6pass", "3pass_wgmma"):
            planes = _planes(route, x)  # held until the launch is queued
            kernels = (_kernels_6pass() if route == "6pass"
                       else _kernels_3pass_wgmma())
            rc = kernels[0](planes.data_ptr(), out.data_ptr(), lse_ptr,
                            *args)
        else:
            rc = _kernel()(x.data_ptr(), out.data_ptr(), lse_ptr,
                           int(x.dtype == torch.bfloat16), *args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, lse, route


def attention_packed(qkv: torch.Tensor, num_heads: int, valid_len: int, *,
                     return_lse: bool = False, precision=None):
    """Attention over the packed projection ``qkv`` [B, S, 3*D] -> [B, S, D].

    CPU tensors take ``attention_packed_plain``. CUDA tensors must be
    contiguous bf16 or fp32 with a head dim in ``KERNEL_HEAD_DIMS``; the
    kernel of ``kernel_route`` is launched on the current stream and
    ``attention_packed.launches`` counts each launch (``launches_3pass``
    those of the 3-pass mode, fp32 under "high", at ``TMA_HEAD_DIMS``
    each after one ``split2`` launch; ``launches_6pass`` those of the
    6-pass route, fp32 there otherwise, each after one ``split3``
    launch). ``return_lse=True`` (CUDA only) also returns each
    row's logsumexp [B, H, S] fp32, which the backward kernel reads."""
    if qkv.device.type == "cpu" and not return_lse:
        return attention_packed_plain(qkv, num_heads, valid_len,
                                      precision=precision)
    out, lse, route = _launch_forward("attention_packed", qkv, num_heads,
                                      valid_len, 3, return_lse, precision)
    _count(attention_packed, route)
    return (out, lse) if return_lse else out


attention_packed.launches = attention_packed.launches_3pass = \
    attention_packed.launches_6pass = 0


def attention_packed_vv(v: torch.Tensor, num_heads: int,
                        valid_len: int, *, precision=None) -> torch.Tensor:
    """V-V attention over a value-only projection ``v`` [B, S, D] ->
    [B, S, D]: softmax(V V^T hd^-1/2) V per head (``flash_attention.py``'s
    ``attention_packed(vv=True, packed_sections=1)``).

    CPU tensors take ``attention_packed_vv_plain``. On CUDA tensors the
    forward kernel of ``kernel_route`` is launched with row stride D and
    all three section offsets at 0, with no logsumexp: the V-V features
    are gradient-free. ``attention_packed_vv.launches`` (and
    ``launches_3pass``, ``launches_6pass``) count these launches apart
    from ``attention_packed``'s."""
    if v.device.type == "cpu":
        return attention_packed_vv_plain(v, num_heads, valid_len,
                                         precision=precision)
    out, _, route = _launch_forward("attention_packed_vv", v, num_heads,
                                    valid_len, 1, False, precision)
    _count(attention_packed_vv, route)
    return out


attention_packed_vv.launches = attention_packed_vv.launches_3pass = \
    attention_packed_vv.launches_6pass = 0


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: int, *, precision=None) -> torch.Tensor:
    """Attention on separate q, k, v [B, H, S, hd] -> [B, H, S, hd] in q's
    dtype (``flash_attention.py``'s ``attention_kernel``): keys at or past
    ``valid_len`` are masked, every row is computed.

    CPU tensors take ``attention_kernel_plain``. On CUDA tensors the
    forward kernel of ``attention_packed``'s ``kernel_route`` is launched
    with this layout's strides (contiguous operands of one shape, dtype
    and device, a head dim in ``KERNEL_HEAD_DIMS``; on the 6-pass and
    3-pass routes at ``TMA_HEAD_DIMS`` each operand's ``split3`` or
    ``split2`` planes); ``attention_kernel.launches`` (and
    ``launches_3pass``, ``launches_6pass``) count its launches."""
    if q.device.type == "cpu":
        return attention_kernel_plain(q, k, v, valid_len,
                                      precision=precision)
    if q.device.type != "cuda":
        raise ValueError(f"attention_kernel: unsupported device {q.device}")
    if q.dim() != 4 or any(t.shape != q.shape or t.dtype != q.dtype
                           or t.device != q.device for t in (k, v)):
        raise ValueError("attention_kernel: q, k and v must be [B, H, S, hd] "
                         "of one shape, dtype and device")
    B, H, S, hd = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention_kernel: dtype {q.dtype} is not bf16 or "
                        f"fp32")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention_kernel: q, k and v must be contiguous "
                         "and 16-byte aligned")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention_kernel: head dim {hd} has no kernel "
                         f"instantiation (have {KERNEL_HEAD_DIMS})")
    route = kernel_route(q.dtype, hd, precision)
    # the wgmma route maps q, k, v themselves; the plane routes their new
    # split planes, aligned when the row stride is
    bases = ([t.data_ptr() for t in (q, k, v)] if route == "wgmma" else [])
    if route in MAP_ROUTES and _tma_misaligned(hd * 2, *bases):
        raise ValueError(f"attention_kernel: a start or the row stride is "
                         f"not a multiple of {TMA_ALIGN} bytes (TMA)")
    if B < 1 or H < 1 or not 1 <= valid_len <= S:
        raise ValueError(f"attention_kernel: need batch, heads >= 1 and "
                         f"1 <= valid_len <= S, got B={B}, H={H}, "
                         f"valid_len={valid_len}, S={S}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (hd, B, S, valid_len, H, hd ** -0.5, stream)
        if route in ("6pass", "3pass_wgmma"):
            planes = [_planes(route, t) for t in (q, k, v)]
            kernels = (_kernels_6pass() if route == "6pass"
                       else _kernels_3pass_wgmma())
            rc = kernels[1](*(t.data_ptr() for t in planes), out.data_ptr(),
                            *args)
        else:
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
            if route == "3pass":
                rc = _kernels_3pass()[1](*ptrs, *args)
            else:
                rc = _bhsd_kernel()(*ptrs, int(q.dtype == torch.bfloat16),
                                    *args)
    if rc != 0:
        raise RuntimeError(f"attention_kernel launch failed: CUDA error {rc}")
    _count(attention_kernel, route)
    return out


attention_kernel.launches = attention_kernel.launches_3pass = \
    attention_kernel.launches_6pass = 0


def attention_packed_bwd(qkv: torch.Tensor, d_out: torch.Tensor,
                         lse: torch.Tensor | None, num_heads: int,
                         valid_len: int, *, precision=None) -> torch.Tensor:
    """``d(qkv)`` [B, S, 3*D] from the packed projection, the output
    cotangent ``d_out`` [B, S, D] and the forward's ``lse`` [B, H, S].

    CPU tensors take ``attention_packed_bwd_plain`` (``lse`` unused). On
    CUDA tensors with a head dim in ``BWD_HEAD_DIMS`` (``KERNEL_HEAD_DIMS``)
    the backward kernel of ``kernel_route`` (the 3-pass mode, fp32 under
    "high", takes the 3-pass forward's ``lse``; the 6-pass route launches
    ``split3`` on qkv and on d_out first, the 3-pass route at
    ``TMA_HEAD_DIMS`` ``split2``) is launched on the current stream and
    ``attention_packed_bwd.launches`` (and ``launches_3pass``,
    ``launches_6pass``) count each call. A call launches two kernels: bf16
    at head dims 88 and 104 the dsum pre-pass and the key-outer kernel,
    which sums dQ over key blocks in a fixed order in a workspace
    allocated here as the source sizes it (``_bwd_workspace_tiles``);
    every other route the query-outer kernel (dsum, then dQ) and the
    key-outer one (dK, dV).
    Every route is deterministic: two calls on the same inputs agree bit
    for bit."""
    if qkv.device.type == "cpu":
        return attention_packed_bwd_plain(qkv, d_out, num_heads, valid_len,
                                          precision=precision)
    (B, S, dm, hd, scale, (q_off, k_off, v_off)), route = _check_cuda(
        "attention_packed_bwd", qkv, num_heads, valid_len,
        precision=precision)
    d_out = d_out.to(qkv.dtype).contiguous()
    if d_out.shape != (B, S, dm) or d_out.device != qkv.device:
        raise ValueError(f"attention_packed_bwd: d_out {tuple(d_out.shape)} "
                         f"on {d_out.device} does not match qkv")
    # d_out's tensor map reads it (wgmma) or its new split planes
    if route in MAP_ROUTES and _tma_misaligned(
            d_out.data_ptr() if route == "wgmma" else 0, dm * 2):
        raise ValueError(f"attention_packed_bwd: d_out's start or row "
                         f"stride is not a multiple of {TMA_ALIGN} bytes "
                         f"(TMA)")
    if (lse is None or lse.shape != (B, num_heads, S)
            or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != qkv.device):
        raise ValueError("attention_packed_bwd: lse must be the forward "
                         "kernel's contiguous fp32 [B, H, S] logsumexp")
    d_qkv = torch.empty_like(qkv)
    dsum = torch.empty_like(lse)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (hd, B, S, valid_len, num_heads, 3 * dm, q_off, k_off, v_off,
                dm, scale, stream)
        rest = (lse.data_ptr(), dsum.data_ptr(), d_qkv.data_ptr())
        if route in ("6pass", "3pass_wgmma"):
            # both held until the launch is queued: a freed qkv split could
            # be handed to d_out's and overwritten before the kernel runs
            planes = (_planes(route, qkv), _planes(route, d_out))
            kernels = (_kernels_6pass() if route == "6pass"
                       else _kernels_3pass_wgmma())
            rc = kernels[2](*(t.data_ptr() for t in planes), *rest, *args)
        elif route == "3pass":
            rc = _kernels_3pass()[2](qkv.data_ptr(), d_out.data_ptr(), *rest,
                                     *args)
        else:
            bf16 = int(qkv.dtype == torch.bfloat16)
            # held until the launch is queued; null where no kernel reads it
            tiles = _bwd_workspace_tiles()(bf16, hd, S)
            work = (_bwd_workspace(tiles, B, num_heads, hd, qkv.device)
                    if tiles else None)
            ptrs = [t.data_ptr() for t in work] if work else [None, None]
            rc = _bwd_kernel()(qkv.data_ptr(), d_out.data_ptr(), *rest, *ptrs,
                               bf16, *args)
    if rc != 0:
        raise RuntimeError(f"attention_packed_bwd kernel launch failed: "
                           f"CUDA error {rc}")
    _count(attention_packed_bwd, route)
    return d_qkv


attention_packed_bwd.launches = attention_packed_bwd.launches_3pass = \
    attention_packed_bwd.launches_6pass = 0


class _PackedAttention(torch.autograd.Function):
    """Packed attention with a backward into ``qkv``, both at
    ``precision``. ``plain=False``: the kernels on CUDA tensors (the
    forward saves qkv and its logsumexp), the plain versions on CPU
    tensors. ``plain=True``: the plain versions on any device (the on-card
    comparison)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, valid_len, plain, precision):
        lse = None
        if plain or qkv.device.type == "cpu":
            out = attention_packed_plain(qkv, num_heads, valid_len,
                                         precision=precision)
        else:
            out, lse = attention_packed(qkv, num_heads, valid_len,
                                        return_lse=True, precision=precision)
        ctx.save_for_backward(qkv, lse)
        ctx.args = (num_heads, valid_len, plain, precision)
        return out

    @staticmethod
    def backward(ctx, d_out):
        qkv, lse = ctx.saved_tensors
        num_heads, valid_len, plain, precision = ctx.args
        if plain:
            d_qkv = attention_packed_bwd_plain(qkv, d_out, num_heads,
                                               valid_len, precision=precision)
        else:
            d_qkv = attention_packed_bwd(qkv, d_out, lse, num_heads,
                                         valid_len, precision=precision)
        return d_qkv, None, None, None, None


def attention_packed_diff(qkv: torch.Tensor, num_heads: int,
                          valid_len: int, *, precision=None) -> torch.Tensor:
    """Differentiable ``attention_packed``: forward and backward kernels
    on CUDA tensors, the plain versions on CPU tensors."""
    return _PackedAttention.apply(qkv, num_heads, valid_len, False,
                                  precision)


def attention_packed_diff_plain(qkv: torch.Tensor, num_heads: int,
                                valid_len: int, *,
                                precision=None) -> torch.Tensor:
    """``attention_packed_diff`` with the plain forward and backward on any
    device: the reference the kernels are held against on the card."""
    return _PackedAttention.apply(qkv, num_heads, valid_len, True, precision)


@torch.library.custom_op("aaclip::attention_packed", mutates_args=())
def attention_packed_op(qkv: torch.Tensor, num_heads: int, valid_len: int,
                        vv: bool, precision: str | None) -> torch.Tensor:
    """B1's forward as a torch operator, ``aaclip::attention_packed``:
    ``attention_packed`` (or ``attention_packed_vv`` with ``vv``) on
    ``qkv``, so that ``torch.export`` captures the kernel call as one node
    (``deploy.py``). Its body is the wrapper: the plain version on CPU
    tensors, on CUDA tensors the hand-written kernel (counted in the
    wrapper's ``launches``) or a raise. No derivative."""
    fn = attention_packed_vv if vv else attention_packed
    return fn(qkv, num_heads, valid_len, precision=precision)


@attention_packed_op.register_fake
def _(qkv, num_heads, valid_len, vv, precision):
    B, S, width = qkv.shape
    return qkv.new_empty(B, S, width if vv else width // 3)


def _forward_op(vv: bool):
    """The forward attention of ``make_attn_fn``'s default hook: the
    ``aaclip::attention_packed`` operator on CPU and CUDA tensors, or the
    wrapper itself where autograd must see the plain CPU version (an input
    that needs a gradient, which the operator does not give) and on any
    other device, which the wrapper refuses (the operator's fake would
    answer a meta tensor)."""
    wrapper = attention_packed_vv if vv else attention_packed

    def attention(x, num_heads, valid_len, *, precision=None):
        if x.device.type not in ("cpu", "cuda") or (
                x.requires_grad and torch.is_grad_enabled()):
            return wrapper(x, num_heads, valid_len, precision=precision)
        return attention_packed_op(x, num_heads, valid_len, vv, precision)

    attention.wrapper = wrapper
    return attention


def make_attn_fn(num_heads: int, policy: DtypePolicy = DtypePolicy(), *,
                 vv: bool = False, differentiable: bool = False,
                 attention=None):
    """``attn_fn`` for ``models/layers.residual_block``: QKV projection in
    the compute dtype (fp32 accumulation, bias in fp32, then cast),
    ``attention`` on the packed result at ``policy.precision``,
    out-projection. ``vv=True`` projects only the value third of
    ``in_proj_weight`` / ``in_proj_bias`` and runs the V-V attention on
    it.

    ``attention`` defaults to the forward kernel wrapper
    (``attention_packed``, or ``attention_packed_vv`` with ``vv``) through
    the ``aaclip::attention_packed`` operator, or with
    ``differentiable=True`` (training steps) to ``attention_packed_diff``;
    the ``*_plain`` versions give the same function with the plain
    arithmetic (the on-card comparison). It is called as ``attention(x,
    num_heads, valid_len, precision=policy.precision)``.

    int8 weights (``ops/quant.py``) take the quantized projections
    (``linear``'s int8 branch, the V-V value third included) on ``x`` as
    given; the attention itself stays in the compute dtype.

    On a tensor-parallel block (``p.tp``, ``parallel/tensor.py``) the
    projection is the rank's packed ``[B, S, 3 D/tp]`` (or its value third)
    with ``num_heads / tp`` heads, which the same kernels take; the
    out-projection's partial sums are reduced over the model axis and the
    bias added once (``layers.row_linear``)."""
    if vv and differentiable:
        # as in the JAX package: stage-1 surgery features are grad-free
        raise ValueError("the V-V attention has no differentiable variant: "
                         "stage-1 feature extraction is gradient-free")
    if attention is None:
        attention = attention_packed_diff if differentiable else \
            _forward_op(vv)
    cd = policy.compute_dtype

    def attn_fn(x: torch.Tensor, p) -> torch.Tensor:
        h = enter(p, x)
        packed = linear(h, **qkv_params(p, value_only=vv),
                        policy=policy).to(cd)
        out = attention(packed, local_heads(p, num_heads), h.shape[1],
                        precision=policy.precision)
        return row_linear(out, p.out_proj, p, policy).to(x.dtype)

    return attn_fn

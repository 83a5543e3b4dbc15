"""Packed-QKV attention: the wrapper around the hand-written CUDA kernel
(``kernels/csrc/attention_packed.cu``), its plain PyTorch version, and the
``attn_fn`` hook that puts it into the residual blocks.

It replaces ``aaclip_tpu/ops/flash_attention.py::attention_packed``
(standard mode): softmax attention read straight out of the packed
projection ``qkv [B, S, 3*D]`` (bias already added), keys at or past
``valid_len`` masked, written token-major ``[B, S, D]`` for the
out-projection.

``attention_packed`` runs the plain version only for tensors on the CPU
(the tests). On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from aaclip_tpu_torch.core.config import DtypePolicy
from aaclip_tpu_torch.models.layers import linear

KERNEL_HEAD_DIMS = (16, 64)  # head dims the kernel is instantiated for


def _split(qkv: torch.Tensor, num_heads: int):
    """(B, S, D, head_dim, scale, (q_off, k_off, v_off)) of a packed
    [B, S, 3*D] projection, offsets in elements."""
    B, S, width = qkv.shape
    if width % 3 or (width // 3) % num_heads:
        raise ValueError(f"packed width {width} does not split into 3 "
                         f"sections of {num_heads} heads")
    dm = width // 3
    hd = dm // num_heads
    return B, S, dm, hd, hd ** -0.5, (0, dm, 2 * dm)


def attention_packed_plain(qkv: torch.Tensor, num_heads: int,
                           valid_len: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 scores, mask,
    max-subtract, exp, fp32 row sum, P cast to the input dtype, P.V in
    fp32, one division at the end. Materialises [B, H, S, S]."""
    B, S, dm, hd, scale, offs = _split(qkv, num_heads)

    def heads(off):
        sec = qkv[..., off:off + dm].reshape(B, S, num_heads, hd)
        return sec.transpose(1, 2).float()

    q, k, v = (heads(off) for off in offs)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if valid_len < S:
        s[..., valid_len:] = float("-inf")
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v) / l
    return o.transpose(1, 2).reshape(B, S, dm).to(qkv.dtype)


@functools.cache
def _kernel():
    """The C entry point of ``csrc/attention_packed.cu``, built on first
    use, with its argument types declared."""
    import ctypes

    from aaclip_tpu_torch.kernels.build import load

    fn = load("attention_packed").aaclip_attention_packed
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    # qkv, out, bf16, head_dim, batch, seq, valid_len, heads, ld,
    # q_off, k_off, v_off, out_ld, scale, stream
    fn.argtypes = [p, p, i, i, i, i, i, i, ll, i, i, i, ll, ctypes.c_float, p]
    fn.restype = i
    return fn


def attention_packed(qkv: torch.Tensor, num_heads: int,
                     valid_len: int) -> torch.Tensor:
    """Attention over the packed projection ``qkv`` [B, S, 3*D] -> [B, S, D].

    CPU tensors take ``attention_packed_plain``. CUDA tensors must be
    contiguous bf16 or fp32 with a head dim in ``KERNEL_HEAD_DIMS``; the
    kernel is launched on the current stream and
    ``attention_packed.launches`` counts each launch."""
    if qkv.device.type == "cpu":
        return attention_packed_plain(qkv, num_heads, valid_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_packed: unsupported device {qkv.device}")
    B, S, dm, hd, scale, (q_off, k_off, v_off) = _split(qkv, num_heads)
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention_packed: dtype {qkv.dtype} is not bf16 "
                        f"or fp32")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("attention_packed: qkv must be contiguous and "
                         "16-byte aligned")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention_packed: head dim {hd} has no kernel "
                         f"instantiation (have {KERNEL_HEAD_DIMS})")
    if B < 1 or not 1 <= valid_len <= S:
        raise ValueError(f"attention_packed: need batch >= 1 and "
                         f"1 <= valid_len <= S, got B={B}, "
                         f"valid_len={valid_len}, S={S}")
    launch = _kernel()
    out = torch.empty(B, S, dm, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            qkv.data_ptr(), out.data_ptr(), int(qkv.dtype == torch.bfloat16),
            hd, B, S, valid_len, num_heads, 3 * dm, q_off, k_off, v_off, dm,
            scale, stream)
    if rc != 0:
        raise RuntimeError(f"attention_packed kernel launch failed: CUDA "
                           f"error {rc}")
    attention_packed.launches += 1
    return out


attention_packed.launches = 0


def make_attn_fn(num_heads: int, policy: DtypePolicy = DtypePolicy(), *,
                 attention=attention_packed):
    """``attn_fn`` for ``models/layers.residual_block``: QKV projection in
    the compute dtype (fp32 accumulation, bias in fp32, then cast),
    ``attention`` on the packed result, out-projection. ``attention``
    defaults to the kernel wrapper; ``attention_packed_plain`` gives the
    same predictor with the plain version (the on-card comparison)."""
    cd = policy.compute_dtype

    def attn_fn(x: torch.Tensor, p) -> torch.Tensor:
        qkv = linear(x, p.in_proj_weight, p.in_proj_bias, policy).to(cd)
        out = attention(qkv, num_heads, x.shape[1])
        out = linear(out, p.out_proj.weight, p.out_proj.bias, policy)
        return out.to(x.dtype)

    return attn_fn

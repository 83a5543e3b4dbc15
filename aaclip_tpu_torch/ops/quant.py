"""int8 quantized inference products (``--precision int8``; the JAX
package's ``aaclip_tpu/ops/quant.py``).

The w8a8 dynamic recipe:

* **Weights**: symmetric per-output-channel int8, fitted at build time to
  the fp32 weights (``quantize_block_weights``). Only the trunk's big
  products are quantized: the packed QKV, the attention out-projection
  and both MLP weights. The patch embedding, LayerNorms, adapters and the
  seg/det heads stay in the policy's compute dtype.
* **Activations**: symmetric per-token int8 on the fly (``dyn_quant``, one
  abs-max per row).
* **Dequant**: the int32 accumulator times the rank-1 outer product of
  the two scale vectors.

The product itself is ``torch._int_mm`` (int8 x int8 -> int32; cuBLASLt on
the card), as JAX computes it with ``jnp.dot(...,
preferred_element_type=int32)`` outside any Pallas kernel. ``dyn_quant``
and the dequant are plain torch ops, as XLA's elementwise glue is in JAX.

Weights keep the port's ``[out, in]`` layout, int8 and contiguous, and
reach ``_int_mm`` as the ``[in, out]`` column-major view ``w.t()``:
cuBLASLt's int8 kernels take that operand transposed, so no call copies
it. Inference only: the training steps refuse an int8 policy.
"""

from __future__ import annotations

import torch

_QUANT_WEIGHTS = (("attn", "in_proj_weight"), ("attn.out_proj", "weight"),
                  ("mlp.c_fc", "weight"), ("mlp.c_proj", "weight"))


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8 of a ``[..., out, in]`` weight:
    ``(int8 [..., out, in], fp32 scales [..., out])`` with ``w ~= q * s``
    (JAX's ``quantize_weight`` on the ``[in, out]`` transpose)."""
    a = w.float()
    s = a.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(a / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dyn_quant(x: torch.Tensor):
    """Symmetric per-token int8 of ``[..., K]``: ``(int8, fp32 per-row scale
    [..., 1])`` with ``x ~= q * m``."""
    a = x.float()
    m = a.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(a / m), -127, 127)
    return q.to(torch.int8), m


def qdot(x: torch.Tensor, w_q: torch.Tensor,
         w_s: torch.Tensor) -> torch.Tensor:
    """``x @ (w_q * w_s).T`` for an int8 ``[out, in]`` weight ``w_q`` and its
    scales ``w_s`` [out]: ``x`` quantized per token, ``torch._int_mm`` of
    the int8 rows and ``w_q.t()`` with int32 accumulation, then the int32
    result times ``m * w_s`` in fp32 (JAX's order). Returns fp32.

    On the card the product is cuBLASLt's int8 GEMM, or ``_int_mm``'s
    error: it never falls back to dequantized weights. ``qdot.launches``
    counts every call."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"qdot: weight dtype {w_q.dtype} is not int8")
    q, m = dyn_quant(x)
    y = torch._int_mm(q.reshape(-1, q.shape[-1]), w_q.t())
    qdot.launches += 1
    y = y.reshape(*q.shape[:-1], w_q.shape[0])
    return y.float() * (m * w_s)


qdot.launches = 0


def quantize_block_weights(block, source=None):
    """Quantize a ``models/layers.ResidualBlock``'s four big weights in
    place: each becomes an int8 parameter (no gradient) with its fp32
    scale buffer ``<name>_s`` beside it; biases, LayerNorms and all else
    are untouched. Returns ``block``.

    ``source`` (a block of the same shapes) supplies the weights to fit
    the int8 grid to: pass the fp32 block when ``block`` is a copy already
    cast to bf16, so the grid is fit to the fp32 values instead of
    rounding twice (bf16's 8-bit mantissa, then int8). The float weights
    are replaced, so the block keeps no float copy of them."""
    src = block if source is None else source
    with torch.no_grad():
        for path, name in _QUANT_WEIGHTS:
            mod, src_mod = block.get_submodule(path), src.get_submodule(path)
            q, s = quantize_weight(getattr(src_mod, name).detach())
            dev = getattr(mod, name).device
            delattr(mod, name)
            mod.register_parameter(
                name, torch.nn.Parameter(q.to(dev), requires_grad=False))
            mod.register_buffer(name + "_s", s.to(dev))
    return block

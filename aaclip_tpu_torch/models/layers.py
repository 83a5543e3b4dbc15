"""Transformer primitives of the vision and text towers, as functions on
tensors, and the ``nn.Module`` containers that hold a block's weights.

Linear weights use torch's ``[out_features, in_features]`` layout (the JAX
package stores ``[in, out]``; ``core/params.py::params_from_jax``
transposes). Numerics follow the JAX package:
 * LayerNorm eps 1e-5, biased variance, fp32 statistics;
 * erf GELU on the fp32 parity policy, tanh GELU on the bf16 fast path;
 * every matmul accumulates in fp32 and returns fp32 (``matmul_f32``),
   fp32 products under the policy's precision "high" as three bf16
   products (``matmul``, ``matmul_3pass``); biases are added in fp32
   before any cast back to the compute dtype;
 * pre-LN residual blocks with packed-QKV multi-head attention, and the
   CLIP-Surgery "V-V" variant whose queries and keys are the values.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from aaclip_tpu_torch.core.config import DtypePolicy

_LN_EPS = 1e-5


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics; returns x's
    dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + _LN_EPS)
    return (y * weight.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (fast path)."""
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def config_act(cfg, policy: DtypePolicy):
    """QuickGELU for a ``quick_gelu`` config in both precisions; otherwise
    erf GELU (fp32) or tanh GELU (bf16) by policy."""
    if getattr(cfg, "quick_gelu", False):
        return quick_gelu
    return gelu_tanh if policy.fast_act else gelu


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cuBLAS ``a @ b`` with fp32 output for same-dtype operands; ``b`` is
    2-D or batched like ``a``."""
    if b.dim() == 2:
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    y = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                  out_dtype=torch.float32)
    return y.reshape(*a.shape[:-1], b.shape[-1])


class _MatmulF32(torch.autograd.Function):
    """``_mm_f32`` with a backward: ``torch.mm(..., out_dtype=)`` has no
    derivative of its own.

    JAX's transpose of a bf16 ``dot(..., preferred_element_type=f32)``
    (read off ``jax.vjp`` of ``layers.linear``) multiplies the fp32
    cotangent with the bf16 operand in fp32 and rounds each gradient to its
    operand's dtype. Here the backward products stay bf16 GEMMs on cuBLAS
    with fp32 output, so the cotangent is rounded to bf16 first, where JAX
    keeps it fp32; the gradients are then rounded to the operands' dtype as
    in JAX. That extra rounding of the cotangent (2^-8 relative) is the
    port's one departure on the card; the on-card step check holds it."""

    @staticmethod
    def forward(ctx, a, b):
        # each gradient needs only the other operand: a frozen weight's
        # product keeps no activation alive
        need_a, need_b = ctx.needs_input_grad
        ctx.save_for_backward(a if need_b else None, b if need_a else None)
        ctx.dtype, ctx.b_2d = a.dtype, b.dim() == 2
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        da = db = None
        g = grad.to(ctx.dtype)
        if ctx.needs_input_grad[0]:
            da = _mm_f32(g, b.transpose(-1, -2)).to(ctx.dtype)
        if ctx.needs_input_grad[1]:
            if ctx.b_2d:
                db = _mm_f32(a.reshape(-1, a.shape[-1]).t(),
                             g.reshape(-1, g.shape[-1]))
            else:
                db = _mm_f32(a.transpose(-1, -2), g)
            db = db.to(ctx.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in fp32 and returned in fp32, for operands of
    one dtype (fp32 or bf16); ``b`` is 2-D or batched like ``a``.

    The JAX package's bf16 products return fp32 (``preferred_element_type``)
    and add the bias before any cast, while a torch bf16 ``matmul`` rounds
    its output to bf16. On the card, ``torch.mm``/``torch.bmm`` with
    ``out_dtype=torch.float32`` keep the fp32 result (``_MatmulF32`` gives
    them a backward). The CPU build has no such kernel, so there the
    bf16-rounded operands are multiplied in fp32, which gives the same
    products (a bf16 x bf16 product is exact in fp32) summed in another
    order, and autograd's backward matches JAX's transpose: the fp32
    cotangent times the bf16 operand, rounded to bf16."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return _mm_f32(a, b)  # no backward to record (inference, export)
    return _MatmulF32.apply(a, b)


def _split_bf16(x: torch.Tensor):
    """fp32 ``x`` as bf16 ``hi + lo``: ``hi = bf16(x)``, ``lo = bf16(x -
    hi)`` (the difference is exact in fp32)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ``a @ b`` with fp32 output, outside autograd: cuBLAS on the
    card (``_mm_f32``); on the CPU the bf16 values multiplied in fp32 (a
    bf16 x bf16 product is exact in fp32)."""
    if a.device.type == "cuda":
        return _mm_f32(a, b)
    return torch.matmul(a.float(), b.float())


def _mm_3pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, al = _split_bf16(a)
    bh, bl = _split_bf16(b)
    return _mm_bf16(ah, bh) + (_mm_bf16(ah, bl) + _mm_bf16(al, bh))


class _Matmul3Pass(torch.autograd.Function):
    """``matmul_3pass`` with its transpose at the same precision: JAX
    transposes a precision-"high" ``dot`` into "high" dots, so dA = g·Bᵀ
    and dB = Aᵀ·g are each 3-pass on the fp32 cotangent (autograd through
    the bf16 casts would round the cotangent to bf16)."""

    @staticmethod
    def forward(ctx, a, b):
        need_a, need_b = ctx.needs_input_grad
        ctx.save_for_backward(a if need_b else None, b if need_a else None)
        ctx.b_2d = b.dim() == 2
        return _mm_3pass(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_3pass(grad, b.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            if ctx.b_2d:
                db = _mm_3pass(a.reshape(-1, a.shape[-1]).t(),
                               grad.reshape(-1, grad.shape[-1]))
            else:
                db = _mm_3pass(a.transpose(-1, -2), grad)
        return da, db


def matmul_3pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b`` as three bf16 products summed in fp32, ``hi·hi +
    (hi·lo + lo·hi)``: XLA's F32_AS_3BF16, the JAX package's precision
    "high" (about 1e-5 relative, where one bf16 pass is 4e-3). On the card
    each product is a cuBLAS bf16 GEMM with fp32 output; on the CPU the
    same split with fp32 products. ``b`` is 2-D or batched like ``a``.
    Differentiable, its gradients 3-pass too (``_Matmul3Pass``)."""
    return _Matmul3Pass.apply(a.float(), b.float())


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: str | None = "highest") -> torch.Tensor:
    """``a @ b`` accumulated in fp32 and returned in fp32 at the JAX
    package's ``precision``: fp32 operands under "high" take
    ``matmul_3pass``; everything else ``matmul_f32`` (true fp32 for fp32
    operands, bf16 operands single-pass)."""
    if precision == "high" and a.dtype == b.dtype == torch.float32:
        return matmul_3pass(a, b)
    return matmul_f32(a, b)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           policy: DtypePolicy = DtypePolicy(),
           scale: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` in the policy's compute dtype with fp32
    accumulation at the policy's precision (``matmul``); returns fp32.

    An int8 ``weight`` (``--precision int8``, ``ops/quant.py``) with its
    per-channel ``scale`` takes the quantized product ``qdot`` on ``x`` as
    given: per-token int8, int32 accumulation, rank-1 dequant."""
    if weight.dtype == torch.int8:
        from aaclip_tpu_torch.ops.quant import qdot

        y = qdot(x, weight, scale)
        return y if bias is None else y + bias.float()
    cd = policy.compute_dtype
    y = matmul(x.to(cd), weight.to(cd).t(), policy.precision)
    if bias is not None:
        y = y + bias.float()
    return y


def linear_params(lin: nn.Module) -> dict:
    """``linear``'s ``weight``, ``bias`` and ``scale`` of a linear layer:
    the scale is the int8 weight's (``ops/quant.py::
    quantize_block_weights``), None for a float one."""
    return dict(weight=lin.weight, bias=lin.bias,
                scale=getattr(lin, "weight_s", None))


def qkv_params(p: nn.Module, value_only: bool = False) -> dict:
    """``linear``'s ``weight``, ``bias`` and ``scale`` of a
    ``PackedAttention``'s packed QKV projection, or of its value third with
    ``value_only`` (the V-V form); the scale is None for float weights."""
    w, b = p.in_proj_weight, p.in_proj_bias
    s = getattr(p, "in_proj_weight_s", None)
    if value_only:
        D = w.shape[0] // 3  # the output width: D / tp on a sharded block
        w, b = w[2 * D:], b[2 * D:]
        s = None if s is None else s[2 * D:]
    return dict(weight=w, bias=b, scale=s)


def enter(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The input of ``p``'s column-parallel products: ``x`` itself, or on a
    tensor-parallel block (``p.tp``, ``parallel/tensor.py``) the model
    axis's copy or sequence all-gather of it."""
    tp = getattr(p, "tp", None)
    return x if tp is None else tp.enter(x)


def row_linear(x: torch.Tensor, lin: nn.Module, p: nn.Module,
               policy: DtypePolicy) -> torch.Tensor:
    """``linear`` through ``lin``, the row-parallel product of ``p`` (the
    out-projection or the MLP's proj), fp32: on a tensor-parallel block the
    partial products are reduced over the model axis (``p.tp.exit``) and
    the bias added once, after the reduction."""
    tp = getattr(p, "tp", None)
    if tp is None:
        return linear(x, **linear_params(lin), policy=policy)
    return tp.exit(linear(x, lin.weight, None, policy)) + lin.bias.float()


def local_heads(p: nn.Module, num_heads: int) -> int:
    """The heads ``p`` holds: all of them, or ``num_heads / tp`` on a
    tensor-parallel block."""
    tp = getattr(p, "tp", None)
    return num_heads if tp is None else tp.heads(num_heads)


def stream_split(tower: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The residual stream entering ``tower``'s blocks: this rank's part of
    the sequence on a sequence-parallel tower (``tower.tp``,
    ``parallel/tensor.py``), else ``x``."""
    tp = getattr(tower, "tp", None)
    return x if tp is None else tp.split(x)


def stream_gather(tower: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``stream_split``: the whole sequence again."""
    tp = getattr(tower, "tp", None)
    return x if tp is None else tp.gather(x)


class PackedAttention(nn.Module):
    """Weights of a multi-head self-attention with one packed QKV
    projection (the OpenAI CLIP layout: ``in_proj_weight`` [3D, D])."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)


class ResidualBlock(nn.Module):
    """Weights of a pre-LN residual attention block (``residual_block``)."""

    def __init__(self, width: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=_LN_EPS)
        self.attn = PackedAttention(width)
        self.ln_2 = nn.LayerNorm(width, eps=_LN_EPS)
        self.mlp = Mlp(width, int(width * mlp_ratio))


def _attention(x: torch.Tensor, p: PackedAttention, num_heads: int, *,
               mask: torch.Tensor | None, vv: bool,
               policy: DtypePolicy, project: bool = True) -> torch.Tensor:
    """The JAX package's XLA-path attention, ``layers.attention``: fp32
    scores from compute-dtype q and k, the additive ``mask``, fp32
    softmax, probabilities cast to the compute dtype before P.V, the
    out-projection (left out, and the fp32 heads' output returned, when
    not ``project``). ``vv`` projects only the value third and uses it as
    q, k and v. On a tensor-parallel block (``p.tp``) the projections are
    the rank's heads between ``enter`` and ``row_linear``'s reduction."""
    dtype = x.dtype
    hd = x.shape[-1] // num_heads
    x = enter(p, x)
    heads = local_heads(p, num_heads)
    B, L, _ = x.shape
    D = heads * hd
    cd = policy.compute_dtype
    if vv:
        v = linear(x, **qkv_params(p, value_only=True), policy=policy)
        q = k = v = v.reshape(B, L, heads, hd).transpose(1, 2)
    else:
        qkv = linear(x, **qkv_params(p), policy=policy)
        qkv = qkv.reshape(B, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
    prec = policy.precision
    scores = matmul(q.to(cd), k.to(cd).transpose(-1, -2), prec) \
        * hd ** -0.5
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = matmul(probs.to(cd), v.to(cd), prec)
    out = out.transpose(1, 2).reshape(B, L, D)
    if not project:
        return out
    return row_linear(out, p.out_proj, p, policy).to(dtype)


def attention(x: torch.Tensor, p: PackedAttention, num_heads: int, *,
              vv: bool = False,
              policy: DtypePolicy = DtypePolicy()) -> torch.Tensor:
    """Plain multi-head self-attention with a packed QKV projection
    (``_attention``, unmasked). A CPU reference only: the vision trunk runs
    the packed-attention hook (``residual_block``), and a tensor on any
    other device is refused."""
    if x.device.type != "cpu":
        raise ValueError(f"layers.attention is the CPU reference; on "
                         f"{x.device} use ops.attention.make_attn_fn")
    return _attention(x, p, num_heads, mask=None, vv=vv, policy=policy)


def masked_attention(x: torch.Tensor, p: PackedAttention, num_heads: int,
                     mask: torch.Tensor, *,
                     policy: DtypePolicy = DtypePolicy()) -> torch.Tensor:
    """The text tower's attention with an additive mask (``causal_mask``),
    on any device. JAX computes it with XLA, outside any Pallas kernel, so
    the port runs it plain on the card too: ``matmul_f32`` products and
    ``torch.softmax`` in fp32, not SDPA, whose roundings differ."""
    return _attention(x, p, num_heads, mask=mask, vv=False, policy=policy)


def attention_vv_batch(x: torch.Tensor, p: PackedAttention, num_heads: int,
                       *, policy: DtypePolicy = DtypePolicy(),
                       valid: torch.Tensor | None = None,
                       data_group=None) -> torch.Tensor:
    """Reference-exact CLIP-Surgery V-V attention across the BATCH at each
    position (the JAX package's ``attention_vv_batch``).

    The reference's surgery attention reads its seq-first input as
    batch-first (reference model/transformer.py:125-152), so its softmax
    runs over the batch's samples at each position and stage-1 features
    depend on the batch's composition. ``valid`` ([B], 0/1) masks padding
    samples out of the key axis, as the reference's smaller unpadded tail
    batch would. The scores are [L, H, B, B]; JAX runs this with XLA and
    the port plain, on any device.

    Under data parallelism (``data_group``, the mesh's data axis) ``x`` and
    ``valid`` are this rank's rows of the global batch: the values and the
    mask are all-gathered over the axis (gradient-free, as every stage-1
    feature is), so this rank's queries attend over the global batch's keys
    and the features equal the single-process ones. On a tensor-parallel
    block (``p.tp``) each rank attends with its heads."""
    dtype = x.dtype
    hd = x.shape[-1] // num_heads
    x = enter(p, x)
    heads = local_heads(p, num_heads)
    B, L, _ = x.shape
    D = heads * hd
    cd = policy.compute_dtype
    v = linear(x, **qkv_params(p, value_only=True), policy=policy)
    v = v.reshape(B, L, heads, hd).permute(1, 2, 0, 3).to(cd)  # [L,H,B,hd]
    keys = v
    if valid is not None:
        valid = torch.as_tensor(valid, device=x.device)
    if data_group is not None:
        from aaclip_tpu_torch.parallel.sharding import all_gather

        keys = all_gather(v, data_group, 2)                    # [L,H,Bg,hd]
        if valid is not None:
            valid = all_gather(valid, data_group, 0)
    prec = policy.precision
    scores = matmul(v, keys.transpose(-1, -2), prec) * hd ** -0.5
    if valid is not None:
        keep = valid.bool()
        scores = torch.where(keep, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = matmul(probs.to(cd), keys, prec)                     # [L,H,B,hd]
    out = out.permute(2, 0, 1, 3).reshape(B, L, D)
    return row_linear(out, p.out_proj, p, policy).to(dtype)


def make_batch_vv_attn_fn(num_heads: int, policy: DtypePolicy, valid=None,
                          data_group=None):
    """``attn_fn`` of the batch-coupled V-V form (``attention_vv_batch``),
    with the optional ``valid`` mask of a padded final batch and the data
    axis of a data-parallel run."""
    return lambda h, p: attention_vv_batch(h, p, num_heads, policy=policy,
                                           valid=valid,
                                           data_group=data_group)


def surgery_vv_start(layers: int, surgery_until_layer: int) -> int:
    """First V-V block index: the surgery tower replaces the last
    ``surgery_until_layer - 1`` blocks with V-V attention (0 when the flag
    exceeds the depth)."""
    return max(0, layers - (surgery_until_layer - 1))


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask [length, length], fp32: 0 on and below the
    diagonal, -inf above (reference model/transformer.py:629-635)."""
    neg = torch.full((length, length), float("-inf"), device=device)
    return torch.triu(neg, diagonal=1)


def mlp(x: torch.Tensor, p: Mlp, act,
        policy: DtypePolicy = DtypePolicy()) -> torch.Tensor:
    h = act(linear(enter(p, x), **linear_params(p.c_fc), policy=policy))
    return row_linear(h, p.c_proj, p, policy).to(x.dtype)


def residual_block(x: torch.Tensor, blk: ResidualBlock, num_heads: int, *,
                   mask: torch.Tensor | None = None, vv: bool = False,
                   act=gelu, policy: DtypePolicy = DtypePolicy(),
                   attn_fn=None, vv_attn_fn=None, block_fn=None,
                   vv_block_fn=None) -> torch.Tensor:
    """Pre-LN residual block. ``attn_fn(x_normed, blk.attn)`` (``vv_attn_fn``
    when ``vv``) returns the projected attention output. Unset, it is the
    packed-attention kernel hook ``ops.attention.make_attn_fn(num_heads,
    policy, vv=vv)``, which runs the kernel on the card and its plain
    version on the CPU; with a ``mask`` (the text tower) it is
    ``masked_attention``. ``block_fn(x, blk)`` (``vv_block_fn`` when
    ``vv``) replaces the whole block: it receives the un-normalised stream
    and returns the block's output (the fused block,
    ``ops.fused_block.make_block_fn``). The hooks and overrides are
    unmasked, so a mask with either raises."""
    whole = vv_block_fn if vv else block_fn
    if whole is not None:
        if mask is not None:
            raise ValueError("block_fn overrides are unmasked (the fused "
                             "kernels take no mask); a masked block takes "
                             "the default masked attention")
        return whole(x, blk)
    override = vv_attn_fn if vv else attn_fn
    if mask is not None:
        if override is not None or vv:
            raise ValueError("attention hooks and the V-V form are "
                             "unmasked; a masked block takes the default "
                             "masked attention")
        override = functools.partial(masked_attention, num_heads=num_heads,
                                     mask=mask, policy=policy)
    elif override is None:
        # imported here: ops.attention imports this module's ``linear``
        from aaclip_tpu_torch.ops.attention import make_attn_fn

        override = make_attn_fn(num_heads, policy, vv=vv)
    h = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
    x = x + override(h, blk.attn)
    h = layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
    return x + mlp(h, blk.mlp, act, policy)


def residual_block_selective(x: torch.Tensor, blk: ResidualBlock,
                             num_heads: int, *,
                             mask: torch.Tensor | None = None, act=gelu,
                             policy: DtypePolicy = DtypePolicy(),
                             attn_fn=None, tail=None) -> torch.Tensor:
    """``residual_block`` (standard form, then ``tail``, the adapter blend,
    when given) with a backward that keeps what the JAX package's selective
    remat keeps (``save_only_these_names("attn_out", "attn_qkv",
    "mlp_fc")``) and recomputes the rest: the same values, less memory than
    no remat, and, unlike full remat, no second attention forward.

    The block runs as checkpoint regions (``torch.utils.checkpoint``, each
    keeping only its inputs) bounded by the kept tensors, with the
    products between them outside any region: a product with a frozen
    weight keeps no activation. Per block the backward keeps
     * ``x``, the input of the ln_1 region;
     * the attention's packed qkv (and on the card its fp32 logsumexp
       [B, H, S]): the ``attn_fn`` hook runs outside any region, and its
       differentiable attention (``ops.attention._PackedAttention``, the
       default here) keeps them for its backward kernel, which never reruns
       the forward;
     * ``x + attn_out`` [B, S, D], the input of the ln_2 region;
     * ``mlp_fc`` [B, S, 4D] fp32, the MLP's pre-activation, the input of
       the activation region (with ``tail``: of the region activation ->
       projection -> residual -> ``tail``, which recomputes the projection,
       as JAX's must, since the adapter's gradient needs its input).
    The attention's output before its out-projection is kept by nothing.
    With a ``mask`` (the text tower, plain attention), JAX names no tensor
    inside the attention, so ln_1 and the whole masked attention up to the
    out-projection form one region, recomputed in the backward.

    A tensor-op policy (``create_selective_checkpoint_contexts``) could not
    do this: the kernels launch through ctypes inside an autograd
    ``Function``, not as aten ops, so such a policy would rerun them."""
    from aaclip_tpu_torch.ops.attention import make_attn_fn

    def region(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False)

    def ln_1(t):
        return layer_norm(t, blk.ln_1.weight, blk.ln_1.bias)

    p = blk.attn
    if mask is not None:
        if attn_fn is not None:
            raise ValueError("attention hooks are unmasked; a masked block "
                             "takes the default masked attention")
        o = region(lambda t: _attention(ln_1(t), p, num_heads, mask=mask,
                                        vv=False, policy=policy,
                                        project=False), x)
        a = row_linear(o, p.out_proj, p, policy)
    else:
        if attn_fn is None:
            attn_fn = make_attn_fn(num_heads, policy, differentiable=True)
        a = attn_fn(region(ln_1, x), p)
    x = x + a.to(x.dtype)
    h = region(lambda t: layer_norm(t, blk.ln_2.weight, blk.ln_2.bias), x)
    fc = linear(enter(blk.mlp, h), blk.mlp.c_fc.weight, blk.mlp.c_fc.bias,
                policy)

    def proj(g, x):
        y = row_linear(g, blk.mlp.c_proj, blk.mlp, policy)
        return x + y.to(x.dtype)

    if tail is None:
        return proj(region(act, fc), x)
    return region(lambda f, x: tail(proj(act(f), x)), fc, x)


def norm_matched_blend(x: torch.Tensor, adapted: torch.Tensor,
                       weight: float) -> torch.Tensor:
    """Rescale the adapter output to the residual stream's per-token norm,
    then convex-blend. The norms are ``sqrt(sum(v * v))`` in the stream's
    dtype, as the JAX package takes them; ``a_norm`` is clamped at 1e-12
    so an all-zero adapter output cannot turn the stream into NaN. The two
    coefficients are rounded to the stream's dtype before the blend, as
    JAX rounds a Python float that meets a bf16 array (0.9 -> 0.8984375)."""
    x_norm = (x * x).sum(-1, keepdim=True).sqrt()
    a_norm = (adapted * adapted).sum(-1, keepdim=True).sqrt().clamp_min(1e-12)
    matched = adapted * (x_norm / a_norm)
    w, one_minus_w = (float(torch.tensor(c, dtype=x.dtype))
                      for c in (weight, 1.0 - weight))
    return w * matched + one_minus_w * x


def simple_adapter(x: torch.Tensor, weight: torch.Tensor,
                   policy: DtypePolicy = DtypePolicy()) -> torch.Tensor:
    """Bias-free Linear + LeakyReLU, in x's dtype."""
    return leaky_relu(linear(x, weight, None, policy)).to(x.dtype)


def simple_proj(x: torch.Tensor, weight: torch.Tensor, relu: bool,
                policy: DtypePolicy = DtypePolicy()) -> torch.Tensor:
    """Bias-free Linear, optionally followed by LeakyReLU, returned in x's
    dtype (the text adapter's final projection)."""
    y = linear(x, weight, None, policy)
    if relu:
        y = leaky_relu(y)
    return y.to(x.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / (x * x).sum(dim, keepdim=True).sqrt()

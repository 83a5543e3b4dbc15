"""Tensor (model) and sequence parallelism for the towers' blocks (the JAX
package's ``aaclip_tpu/parallel/tensor.py``), Megatron's layout per
block:

* the QKV projection column-parallel over attention heads (each rank owns
  ``heads / tp`` whole heads, so scores, softmax and context need no
  communication);
* the attention out-projection row-parallel (one sum over the model axis
  restores the residual stream);
* the MLP's fc column-parallel over the hidden width, its proj
  row-parallel (one more sum);

two reductions per block. The out-projection's and proj's biases are
added once, after the reduction.

A departure in layout, not in math, from JAX's ``make_tp_attn_fn``: JAX
repacks the QKV columns head-major so that GSPMD's sharding of one global
tensor follows the heads, and runs einsums. The port keeps no global
tensor: rank m takes columns [m D/tp, (m+1) D/tp) of EACH of the q, k and
v thirds (``shard_tower``), so its local projection is ``[B, S, 3 D/tp]``
in the packed order the attention kernels read, with ``heads / tp``
heads. The forward (B1), backward (B2) and V-V (B3) kernels then run per
rank unchanged; no head-major repack and no B4 is needed on this path.

Sequence parallelism (Megatron-SP, JAX's ``make_sp_constraint``) keeps
the residual stream sharded over the sequence across the model axis
between blocks: each block all-gathers it before the QKV and fc products
and reduce-scatters after the out-projection and proj, so LayerNorms,
residual adds and adapter blends each see S/tp tokens. S need not divide
by tp (S = 37² + 1 = 1370 at 518 px does not divide by 4): the stream is
padded to a multiple of tp on entry (the last token repeated) and
trimmed after every gather, and the partial sums are padded with zeros
before each reduce-scatter. Pad rows never reach a gathered tensor, so
their cotangent is zero.

A sharded tower carries its ``ModelAxis`` as ``tower.tp``, and every
block's attention and MLP as ``p.tp``: ``models/layers.py`` reads it
there, and the towers' trunks (``models/vit.py``, ``models/text_model.
py``) split the stream on entry and gather it on exit.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from aaclip_tpu_torch.parallel import sharding as S
from aaclip_tpu_torch.parallel.sharding import Mesh


class ModelAxis:
    """The model axis as a sharded tower's blocks see it: ``enter`` before
    the column-parallel products, ``exit`` after the row-parallel ones
    (fp32 partial sums in, the reduced stream out), ``split`` and
    ``gather`` on the trunk's entry and exit. Without sequence parallelism
    the stream stays replicated: ``enter`` is Megatron's copy (all-reduce
    backward), ``exit`` its reduction (identity backward), ``split`` and
    ``gather`` the identity. ``split`` records the sequence length that
    later gathers trim to."""

    def __init__(self, mesh: Mesh, sequence_parallel: bool = False):
        self.group, self.size = mesh.model, mesh.tp
        self.sp = sequence_parallel
        self._seq = self._padded = None

    def __deepcopy__(self, memo):
        # a copy of a sharded tower (the policy's cast) shares its axis
        return self

    def heads(self, heads: int) -> int:
        return heads // self.size

    def split(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sp:
            return x
        s = x.shape[1]
        self._seq, self._padded = s, -(-s // self.size) * self.size
        pad = self._padded - s
        if pad:
            x = torch.cat([x, x[:, -1:].expand(-1, pad, -1)], dim=1)
        return S.split(x, self.group, 1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sp:
            return x
        return S.gather_replicated(x, self.group, 1)[:, :self._seq]

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        if not self.sp:
            return S.copy_to(h, self.group)
        return S.gather_to(h, self.group, 1)[:, :self._seq]

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        if not self.sp:
            return S.reduce_from(y, self.group)
        pad = self._padded - y.shape[1]
        if pad:
            y = F.pad(y, (0, 0, 0, pad))
        return S.scatter_from(y, self.group, 1)


def check_divisible(heads: int, hidden: int, tp: int) -> None:
    """JAX's ``_shard_tower`` checks: tp divides the heads and the MLP's
    hidden width."""
    if heads % tp:
        raise ValueError(
            f"model-parallel size {tp} must divide head count {heads}")
    if hidden % tp:
        raise ValueError(
            f"model-parallel size {tp} must divide MLP hidden dim {hidden}")


def _param(t: torch.Tensor, like: nn.Parameter, dev) -> nn.Parameter:
    return nn.Parameter(t.detach().to(dev).contiguous(),
                        requires_grad=like.requires_grad)


def _shard_block(blk: nn.Module, tp: int, m: int, axis: ModelAxis,
                 dev) -> nn.Module:
    """Rank ``m``'s part of one ``layers.ResidualBlock``: a module of the
    same structure whose packed QKV holds rows [m D/tp, (m+1) D/tp) of each
    of the q, k and v thirds, the out-projection and proj the matching
    input columns (their biases whole), fc the matching hidden rows."""
    from aaclip_tpu_torch.models.layers import ResidualBlock

    w_qkv = blk.attn.in_proj_weight
    if w_qkv.dtype == torch.int8:
        raise ValueError("tensor parallelism does not recognize int8 block "
                         "weights; int8/quantized towers do not compose "
                         "with --tensor_parallel")
    D = w_qkv.shape[1]
    hidden = blk.mlp.c_fc.weight.shape[0]
    d, h = D // tp, hidden // tp
    with torch.device("meta"):
        out = ResidualBlock(D, hidden / D)
    rows = torch.cat([torch.arange(s * D + m * d, s * D + (m + 1) * d)
                      for s in range(3)]).to(w_qkv.device)
    a, o = blk.attn, out.attn
    o.in_proj_weight = _param(a.in_proj_weight[rows], a.in_proj_weight, dev)
    o.in_proj_bias = _param(a.in_proj_bias[rows], a.in_proj_bias, dev)
    o.out_proj.weight = _param(a.out_proj.weight[:, m * d:(m + 1) * d],
                               a.out_proj.weight, dev)
    o.out_proj.bias = _param(a.out_proj.bias, a.out_proj.bias, dev)
    f, g = blk.mlp, out.mlp
    g.c_fc.weight = _param(f.c_fc.weight[m * h:(m + 1) * h], f.c_fc.weight,
                           dev)
    g.c_fc.bias = _param(f.c_fc.bias[m * h:(m + 1) * h], f.c_fc.bias, dev)
    g.c_proj.weight = _param(f.c_proj.weight[:, m * h:(m + 1) * h],
                             f.c_proj.weight, dev)
    g.c_proj.bias = _param(f.c_proj.bias, f.c_proj.bias, dev)
    for name in ("ln_1", "ln_2"):
        src, dst = getattr(blk, name), getattr(out, name)
        dst.weight = _param(src.weight, src.weight, dev)
        dst.bias = _param(src.bias, src.bias, dev)
    o.tp = g.tp = axis
    return out


def shard_tower(tower: nn.Module, heads: int, mesh: Mesh,
                sequence_parallel: bool = False) -> nn.Module:
    """This rank's part of a vision or text tower on ``mesh.device``: the
    blocks Megatron-sharded over the model axis (``_shard_block``), every
    other parameter whole; the tower may live on the CPU, so that a rank
    holds only its part of each sharded weight on its card. The result
    carries ``tower.tp``, the ``ModelAxis``; only the port's trunks run it
    (its blocks hold 1/tp of the heads)."""
    tp = mesh.tp
    check_divisible(heads, tower.blocks[0].mlp.c_fc.weight.shape[0], tp)
    axis = ModelAxis(mesh, sequence_parallel)
    blocks = tower.blocks
    tower.blocks = nn.ModuleList()
    try:
        out = copy.deepcopy(tower).to(mesh.device)
    finally:
        tower.blocks = blocks
    out.blocks = nn.ModuleList(
        _shard_block(b, tp, mesh.model_rank, axis, mesh.device)
        for b in blocks)
    out.tp = axis
    return out


def sp_trunk_params(adapter: nn.Module) -> list:
    """Parameters of an image or text adapter that act inside the
    sequence-sharded trunk (the per-block adapters): under sequence
    parallelism each rank's gradient of them covers its tokens only, so
    they are summed over the model axis too (Megatron's rule for the
    LayerNorms of its sequence-parallel region). The projections after
    the trunk see the gathered stream, and their gradients are whole on
    every rank."""
    return list(adapter.layer_adapters.parameters())

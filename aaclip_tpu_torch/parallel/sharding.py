"""The device mesh as process groups, and the collectives that run on it
(the JAX package's ``aaclip_tpu/parallel/sharding.py`` and the mesh half
of ``parallel/tensor.py``).

The JAX package is single-controller: one process drives a ``('data',)``
or ``('data', 'model')`` mesh and GSPMD inserts the collectives. The port
runs one process per card (``torchrun``) with explicit collectives:

* ``initialize_multihost`` joins the process group ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``): NCCL on the card, gloo on the CPU;
* ``Mesh`` holds the ``data`` and ``model`` process groups, their sizes,
  this rank's coordinates and its device; ``make_data_mesh`` and
  ``make_mesh_2d`` build it in JAX's device order, the model axis the
  fastest (rank = d * tp + m);
* ``shard_rows`` / ``gather_rows`` deal a global batch to the data ranks
  as JAX's per-host loaders deal rows (rows r, r + dp, ... to data rank
  r; the ranks of one model group share them) and all-gather per-rank
  outputs back in global order. The CLIs' loaders read only their rank's
  rows of each global batch (``BatchLoader(deal_batches=True)``, the
  batch padded first with ``pad_batch_to_devices``, JAX's padding), the
  training steps take them, and the predictors are ``gather_rows`` of
  their per-rank body on ``shard_rows`` of the global batch (JAX's call
  contract: the global batch in, the global result out);
* the differentiable collectives are Megatron's pair (``copy_to``:
  identity forward, all-reduce backward; ``reduce_from``: all-reduce
  forward, identity backward) and, for sequence parallelism, all-gather
  with reduce-scatter as its backward and the reverse. ``torch.distributed.
  nn.functional.all_reduce`` is not used for the row-parallel sum: its
  backward all-reduces the cotangent, which every rank already holds
  whole after that sum, so gradients would come out tp times too large.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from aaclip_tpu_torch.device import resolve_device


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def initialize_multihost(device=None) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment; returns whether one is up. Nothing happens when neither
    ``RANK`` nor ``WORLD_SIZE`` is set (a single-process run), and one
    without the other raises, as JAX refuses ``JAX_NUM_PROCESSES`` without
    ``JAX_PROCESS_ID``. The backend is NCCL for a CUDA ``device`` (None is
    the card, ``cuda:LOCAL_RANK``) and gloo for the CPU; on the card the
    rank's device becomes the current one."""
    if dist.is_initialized():
        return True
    rank, world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if not rank and not world:
        return False
    if bool(rank) != bool(world):
        raise RuntimeError("set BOTH RANK and WORLD_SIZE (or neither, for a "
                           "single-process run); torchrun sets both")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(dev), init_method="env://",
                            rank=int(rank), world_size=int(world))
    return True


def _ensure_group(dev: torch.device) -> None:
    """A world of one when no process group is up: a mesh in a plain
    single-process run, as JAX's mesh of one device."""
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``('data', 'model')`` mesh of processes: ``data`` joins the ranks
    that share this rank's model coordinate (the data axis), ``model``
    those that share its data coordinate. A data mesh has ``tp`` 1."""
    dp: int
    tp: int
    rank: int
    data_rank: int
    model_rank: int
    data: object
    model: object
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.tp}

    @property
    def is_lead(self) -> bool:
        """Rank 0: the one that logs and writes files."""
        return self.rank == 0


def _build_mesh(tp: int, device) -> Mesh:
    dev = resolve_device(device)
    _ensure_group(dev)
    n = dist.get_world_size()
    if tp < 1 or n % tp:
        raise ValueError(f"tensor_parallel={tp} must divide device count {n}")
    dp, rank = n // tp, dist.get_rank()
    data = model = None
    # every rank creates every group, in one order
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(dp)])
        if rank % tp == m:
            data = g
    for d in range(dp):
        g = dist.new_group([d * tp + m for m in range(tp)])
        if rank // tp == d:
            model = g
    return Mesh(dp=dp, tp=tp, rank=rank, data_rank=rank // tp,
                model_rank=rank % tp, data=data, model=model, device=dev)


def make_data_mesh(*, device=None) -> Mesh:
    """The 1-D data mesh over every process (JAX's ``make_data_mesh``; one
    process drives one card, so a mesh always spans the world). ``device``
    is this rank's (None: the card, ``cuda:LOCAL_RANK``)."""
    return _build_mesh(1, device)


def make_mesh_2d(tp: int, *, device=None) -> Mesh:
    """The ``(world // tp, tp)`` mesh with axes ``('data', 'model')``, the
    model axis innermost (JAX's ``make_mesh_2d``)."""
    return _build_mesh(tp, device)


def cli_mesh(data_parallel: bool, tensor_parallel: int,
             device=None) -> Optional[Mesh]:
    """The CLIs' mesh: ``--tensor_parallel N`` a 2-D one, ``--data_parallel``
    a data mesh, over ``torchrun``'s world (or a world of one); None
    without either flag."""
    if not (data_parallel or tensor_parallel > 1):
        return None
    initialize_multihost(device)
    if tensor_parallel > 1:
        return make_mesh_2d(tensor_parallel, device=device)
    return make_data_mesh(device=device)


def is_tp_mesh(mesh) -> bool:
    return mesh is not None and mesh.tp > 1


def pad_batch_to_devices(arrays: Iterable[np.ndarray], valid: np.ndarray,
                         n_devices: int):
    """Pad leading dims to a multiple of the mesh size by repeating the
    last row, extending the validity mask with zeros so losses and metrics
    ignore the padding."""
    arrays = list(arrays)
    b = arrays[0].shape[0]
    for a in arrays[1:]:
        if a.shape[0] != b:
            raise ValueError(
                f"pad_batch_to_devices: leading dims differ "
                f"({a.shape[0]} vs {b}) — padding from arrays[0] would "
                f"produce inconsistent batches")
    if len(valid) != b:
        raise ValueError(
            f"pad_batch_to_devices: valid mask length {len(valid)} != "
            f"batch {b}")
    target = ((b + n_devices - 1) // n_devices) * n_devices
    if target == b:
        return arrays, valid
    pad = target - b
    out = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
           for a in arrays]
    valid = np.concatenate([valid, np.zeros((pad,), valid.dtype)])
    return out, valid


def shard_rows(x, mesh: Optional[Mesh], device=None) -> torch.Tensor:
    """This rank's rows of the global batch ``x`` (rows ``data_rank``,
    ``data_rank + dp``, ...; the whole batch without a mesh), on
    ``device`` when one is given: taken before the copy, so a host batch
    uploads only its rank's rows. The data size must divide the batch
    (``pad_batch_to_devices`` pads one)."""
    x = torch.as_tensor(x)
    if mesh is not None:
        if x.shape[0] % mesh.dp:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"data-parallel size {mesh.dp}")
        x = x[mesh.data_rank::mesh.dp].contiguous()
    return x if device is None else x.to(device)


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh],
                dim: int = 0) -> torch.Tensor:
    """The inverse of ``shard_rows``: every data rank's rows along ``dim``
    (the batch axis; as many on each rank), all-gathered over the data
    axis and put back in global order (not differentiable)."""
    if mesh is None or mesh.dp == 1:
        return x
    g = all_gather(x, mesh.data, dim).movedim(dim, 0)
    rest = tuple(g.shape[1:])
    g = g.reshape((mesh.dp, x.shape[dim]) + rest).transpose(0, 1)
    return g.reshape((-1,) + rest).movedim(0, dim)


# ---------------------------------------------------------------------------
# Collectives. The ``*_single`` names are the newer torch's; older ones
# have only the ``*_tensor`` forms.

_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    _all_gather_single(out, xm, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's sum, this rank's equal part along ``dim``."""
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"reduce_scatter: size {xm.shape[0]} along dim "
                         f"{dim} does not divide by {n}")
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    _reduce_scatter_single(out, xm, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum, in a new tensor."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def own_part(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    per = x.shape[dim] // n
    return x.narrow(dim, r * per, per)


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a
    column-parallel product, whose cotangent is a partial sum per rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a row-parallel
    product, after which every rank holds the whole cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTo(torch.autograd.Function):
    """All-gather forward along ``dim``, reduce-scatter backward: a
    sequence-sharded stream gathered for column-parallel products."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterFrom(torch.autograd.Function):
    """Reduce-scatter forward along ``dim``, all-gather backward: the
    partial outputs of row-parallel products, summed into this rank's
    sequence part."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather forward along ``dim``, split backward: a sharded stream
    gathered into a computation every rank repeats whole, so each rank's
    cotangent is already the whole one and it keeps its own part."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return own_part(g, ctx.group, ctx.dim).contiguous(), None, None


class _Split(torch.autograd.Function):
    """Own part forward along ``dim``, all-gather backward: a replicated
    stream entering the sequence-sharded region."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return own_part(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherTo.apply(x, group, dim)


def scatter_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _ScatterFrom.apply(x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherReplicated.apply(x, group, dim)


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _Split.apply(x, group, dim)


def all_reduce_grads(params, group) -> None:
    """Sum the gradients of ``params`` over ``group`` in place, in one
    flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()

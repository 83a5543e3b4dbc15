"""Pipeline parallelism, GPipe-style: the predictor, the stage-1
surgery features and the stage-2 step (the JAX package's
``aaclip_tpu/parallel/pipeline.py``).

The adapted forward taps the residual stream at evenly spaced depths
(6/12/18/24 of 24 for ViT-L) and reduces each tap through its own head
before the level maps are summed. So the trunk splits into ``pp``
contiguous stages whose boundaries fall on tap depths: each stage holds
``layers / pp`` blocks (and the adapters that fall in them), runs the
heads of its own taps, and the level sum becomes one all-reduce over the
stage group. Microbatches stream from stage to stage; the only traffic
is the [B_m, S, D] residual stream between neighbouring stages (a "hop")
and that one reduction.

JAX runs one SPMD program per stage (``shard_map``), so it pads the
adapter stacks with dummies to the full depth and gates the blend on a
per-layer weight. The port runs one process per stage (``torch.
distributed``, one card each): a stage builds only its own blocks and the
adapters and heads that fall in them, and needs neither the padding nor
the gate; the results and the error messages are JAX's.

``make_pp_mesh(pp, dp)`` lays the world out as JAX's ``('stage',
'data')`` mesh: rank ``d * pp + s`` is stage ``s`` of replica ``d``, so a
replica's stages are neighbouring ranks. Each replica is a stage group;
the ranks of one stage across the replicas are a data group. The data
axis splits the batch: each replica runs its rows of every microbatch
(``sharding.shard_rows``' rows r, r + dp, ...).

The schedule is GPipe's. Stage ``s`` runs microbatch ``m`` after stage
``s - 1`` has sent it, so the stages overlap as JAX's ``n_micro + pp - 1``
ticks do; the backward of the stage-2 step runs the microbatches in the
same order after every forward, each stage receiving the gradient of its
output from the next and sending that of its input to the previous, and
the gradients add up over the microbatches in that fixed order. Each hop
is a blocking ``send``/``recv`` between the two neighbours, so no two
ranks wait on each other. Between two processes on one card the world's
backend is gloo (NCCL refuses two ranks on one device), whose
point-to-point calls take host tensors only: there a hop is copied to
the host, sent, and copied back to the card. The blocks' compute stays on
the card either way; across cards NCCL sends the device tensor itself.
"""

from __future__ import annotations

import copy
import dataclasses
from types import SimpleNamespace
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from aaclip_tpu_torch.core.config import AdapterConfig, CLIPConfig, DtypePolicy
from aaclip_tpu_torch.core.params import (cast_block_matrices,
                                          cast_matmul_weights)
from aaclip_tpu_torch.device import resolve_device
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.models.vit import ImageAdapter, VisionTransformer, embed
from aaclip_tpu_torch.ops import losses as LL
from aaclip_tpu_torch.ops.attention import make_attn_fn
from aaclip_tpu_torch.ops.similarity import (apply_postproc_matrix,
                                             image_score, level_scores,
                                             train_similarity_logit)
from aaclip_tpu_torch.parallel import sharding as sh


@dataclasses.dataclass(frozen=True, eq=False)
class PipeMesh:
    """A ``('stage', 'data')`` mesh of processes: ``stage`` joins this
    rank's replica (its ``pp`` stages, neighbouring ranks), ``data`` the
    ranks that hold the same stage in every replica. A rank past ``pp *
    dp`` (the world may be larger, as JAX's device list may be) is in no
    group and has ``stage_rank`` None."""
    pp: int
    dp: int
    rank: int
    stage_rank: Optional[int]
    data_rank: Optional[int]
    stage: object
    data: object
    device: torch.device

    @property
    def is_lead(self) -> bool:
        """Rank 0: the one that logs and writes files."""
        return self.rank == 0

    @property
    def active(self) -> bool:
        return self.stage_rank is not None

    def peer(self, stage: int) -> int:
        """The global rank of ``stage`` in this rank's replica."""
        return self.data_rank * self.pp + stage


def make_pp_mesh(pp: int, dp: int = 1, *, device=None) -> PipeMesh:
    """The ``('stage', 'data')`` mesh over the first ``pp * dp`` ranks of
    the world (a world of one when no process group is up), in JAX's
    layout: ``mesh.devices[s, d] = devices[d * pp + s]``, each replica a
    contiguous run of ``pp`` ranks, so a hop goes to the neighbouring
    rank. Every rank of the world must call it (it creates the groups).
    ``device`` is this rank's (None: the card, ``cuda:LOCAL_RANK``)."""
    dev = resolve_device(device)
    sh._ensure_group(dev)
    n = dist.get_world_size()
    if pp < 2 or pp > n:
        raise ValueError(f"pipeline_parallel={pp} needs 2..{n} devices")
    if dp < 1 or pp * dp > n:
        raise ValueError(
            f"pipeline dp={dp} needs pp*dp <= {n} devices (pp={pp})")
    rank = dist.get_rank()
    stage = data = None
    # every rank creates every group, in one order
    for d in range(dp):
        g = dist.new_group([d * pp + s for s in range(pp)])
        if rank // pp == d:
            stage = g
    for s in range(pp):
        g = dist.new_group([d * pp + s for d in range(dp)])
        if rank < pp * dp and rank % pp == s:
            data = g
    active = rank < pp * dp
    return PipeMesh(pp=pp, dp=dp, rank=rank,
                    stage_rank=rank % pp if active else None,
                    data_rank=rank // pp if active else None,
                    stage=stage if active else None, data=data, device=dev)


def _mesh_for(pp: int, dp: int, mesh: Optional[PipeMesh], device,
              idle_ok: bool = False):
    if mesh is None:
        mesh = make_pp_mesh(pp, dp, device=device)
    elif (mesh.pp, mesh.dp) != (pp, dp):
        raise ValueError(f"mesh is stage={mesh.pp} x data={mesh.dp}, "
                         f"asked for pp={pp}, dp={dp}")
    if not mesh.active and not idle_ok:
        raise ValueError(f"rank {mesh.rank} is outside the pp*dp="
                         f"{pp * dp} mesh")
    if mesh.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return mesh


def _validate(cfg: CLIPConfig, acfg: AdapterConfig, pp: int) -> int:
    """Check the level structure is pipelineable; returns taps per
    stage."""
    v = cfg.vision
    levels = tuple(acfg.levels)
    n_lev = len(levels)
    if n_lev == 0:
        raise ValueError("pipeline parallelism needs at least one level")
    if v.layers % n_lev:
        raise ValueError(
            f"pipeline parallelism needs evenly spaced levels: {n_lev} "
            f"levels do not divide {v.layers} layers")
    spacing = v.layers // n_lev
    expect = tuple(spacing * (i + 1) for i in range(n_lev))
    if levels != expect:
        raise ValueError(
            f"pipeline parallelism needs evenly spaced levels ending at the "
            f"last layer (got {levels}, need {expect})")
    if n_lev % pp:
        raise ValueError(
            f"pipeline_parallel={pp} must divide the level count {n_lev} "
            f"(stage boundaries sit on tap depths)")
    return n_lev // pp


def _stage_split(vit: VisionTransformer, lo: int, hi: int,
                 dev: torch.device) -> VisionTransformer:
    """The tower with only blocks [lo, hi), on ``dev``: a stage's share of
    the trunk (everything outside the blocks is small and kept whole).
    Blocks already on ``dev`` are shared with ``vit``, others copied."""
    blocks = vit.blocks
    vit.blocks = nn.ModuleList()
    try:
        stage = copy.deepcopy(vit).to(dev)
    finally:
        vit.blocks = blocks
    own = nn.ModuleList(blocks[lo:hi])
    at = next(own.parameters()).device
    if at.type != dev.type or dev.index not in (None, at.index):
        own = copy.deepcopy(own).to(dev)
    stage.blocks = own
    return stage


def _check_adapters(image_adapter: ImageAdapter, n_adapt: int) -> None:
    """The stack depth must equal ``acfg.image_adapt_until``: the stages
    pick their adapters by the configured depth, so a mismatched stack
    would blend the wrong ones instead of failing like the single-device
    trunk."""
    depth = len(image_adapter.layer_adapters)
    if depth != n_adapt:
        raise ValueError(
            f"adapter stack depth {depth} != image_adapt_until="
            f"{n_adapt} — pass the AdapterConfig these adapters were "
            "built with")


def _batch_error(B: int, n_micro: int, dp: int) -> None:
    if B % (n_micro * dp):
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}"
                         + (f" * dp={dp}" if dp > 1 else ""))


class _Hops:
    """The point-to-point hops of this rank's replica: ``send(x, stage)``
    and ``recv(shape, dtype, stage)``. Tensors travel as bytes (gloo has
    no bf16 point-to-point type); on a CUDA rank of a gloo world they go
    through a pinned host buffer per shape."""

    def __init__(self, mesh: PipeMesh):
        self.mesh = mesh
        self.host = (mesh.device.type == "cuda"
                     and dist.get_backend(mesh.stage) == "gloo")
        self._bufs = {}

    def _buffer(self, shape, dtype, slot):
        key = (tuple(shape), dtype, slot)
        if key not in self._bufs:
            self._bufs[key] = torch.empty(shape, dtype=dtype,
                                          pin_memory=True)
        return self._bufs[key]

    def send(self, x: torch.Tensor, stage: int) -> None:
        x = x.detach().contiguous()
        if self.host:
            buf = self._buffer(x.shape, x.dtype, "send")
            buf.copy_(x)
            x = buf
        dist.send(x.view(torch.uint8), self.mesh.peer(stage),
                  group=self.mesh.stage)

    def recv(self, shape, dtype, stage: int) -> torch.Tensor:
        if self.host:
            buf = self._buffer(shape, dtype, "recv")
        else:
            buf = torch.empty(shape, dtype=dtype, device=self.mesh.device)
        dist.recv(buf.view(torch.uint8), self.mesh.peer(stage),
                  group=self.mesh.stage)
        return buf.to(self.mesh.device) if self.host else buf


def _run_blocks(x, tower, first, cfg, lo, hi, adapter, n_adapt,
                adapt_weight, *, act, policy, attn_fn, remat=False):
    """Blocks [lo, hi) of the tower, a stage's whose first block is block
    ``first`` (``tower.blocks[i - first]``), each followed by the
    norm-matched blend with adapter ``i`` while ``i < n_adapt``
    (``models/vit.py::trunk_taps``' block); under ``remat`` each block
    whose input carries a gradient is checkpointed, as there."""
    heads = cfg.vision.heads

    def block(x, i):
        x = L.residual_block(x, tower.blocks[i - first], heads, act=act,
                             policy=policy, attn_fn=attn_fn)
        if i >= n_adapt:
            return x
        a = L.simple_adapter(x, adapter.layer_adapters[i].weight, policy)
        return L.norm_matched_blend(x, a, adapt_weight)

    for i in range(lo, hi):
        if remat and x.requires_grad:
            x = checkpoint(block, x, i, use_reentrant=False)
        else:
            x = block(x, i)
    return x


class _Plan:
    """A stage's share of the adapted trunk: its blocks [lo, hi), the
    levels whose taps fall in it (``own``, indices into ``acfg.levels``)
    and whether it holds the last level (the det head)."""

    def __init__(self, cfg: CLIPConfig, acfg: AdapterConfig, pp: int,
                 stage: int):
        tps = _validate(cfg, acfg, pp)
        spacing = cfg.vision.layers // len(acfg.levels)
        self.ls = tps * spacing
        self.lo, self.hi = stage * self.ls, (stage + 1) * self.ls
        self.own = list(range(stage * tps, (stage + 1) * tps))
        self.spacing = spacing
        self.first, self.last = stage == 0, stage == pp - 1


def _taps(x, plan, tower, cfg, acfg, adapter, *, act, policy, attn_fn,
          remat=False):
    """The stage's taps (one after each ``spacing`` blocks) and its output
    stream (the last tap)."""
    taps = []
    for k in range(len(plan.own)):
        lo = plan.lo + k * plan.spacing
        x = _run_blocks(x, tower, plan.lo, cfg, lo, lo + plan.spacing,
                        adapter, acfg.image_adapt_until,
                        acfg.image_adapt_weight, act=act, policy=policy,
                        attn_fn=attn_fn, remat=remat)
        taps.append(x)
    return taps


def _heads(taps, plan, tower, adapter, acfg, policy):
    """Each own tap through ln_post, its seg projection and the L2 norm
    (``adapted_forward``'s heads): the stacked seg tokens [n_own, B, L,
    E] and, on the last stage, the det token [B, E]."""
    def proj_norm(t, lin):
        y = L.linear(t, lin.weight, None, policy)
        if acfg.proj_relu:
            y = L.leaky_relu(y)
        return L.l2_normalize(y)

    tokens = [L.layer_norm(t[:, 1:, :], tower.ln_post.weight,
                           tower.ln_post.bias) for t in taps]
    seg = torch.stack([proj_norm(t, adapter.seg_proj[k])
                       for k, t in zip(plan.own, tokens)])
    det = proj_norm(tokens[-1], adapter.det_proj).mean(dim=1) \
        if plan.last else None
    return seg, det


def _microbatches(x: torch.Tensor, n_micro: int):
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


def make_pipeline_predict_fn(vit: VisionTransformer, cfg: CLIPConfig,
                             acfg: AdapterConfig, *, pp: int,
                             n_micro: Optional[int] = None, dp: int = 1,
                             img_size: int | None = None,
                             policy: DtypePolicy = DtypePolicy(),
                             attn_fn=None, mesh: Optional[PipeMesh] = None,
                             device=None) -> Callable:
    """The pipeline drop-in for ``eval.predict.make_predict_fn``:
    ``predict(image_adapter, images, anchors, M) -> (pixel_map [B, img,
    img], image_score [B])`` on the global batch of normalised float
    images (JAX's pipeline takes no uint8 inputs), returned on every rank
    of the mesh.

    The trunk's blocks live ``layers / pp`` per stage (``vit`` may live
    on the CPU; each rank keeps its stage's blocks on its card) and
    ``n_micro`` microbatches (default ``pp``) stream through them. Each
    stage scores its own levels; one all-reduce over the stage group sums
    them, and the det token, which only the last stage computes, rides
    along as zeros elsewhere. ``dp > 1`` replicates the pipeline over the
    data axis, each replica running its rows of every microbatch (the
    batch must divide by ``n_micro * dp``). ``attn_fn`` is the attention
    hook of every block (default: the packed-attention kernel hook);
    whole blocks stay on one rank, so the kernels run unchanged. The
    staged trunk (``policy.bf16_until``) and int8 are refused, as by JAX.

    ``predict.raw(visual, adapter, images, anchors, M)`` is the same
    function with the stage's prepared tower (``predict.visual``, by name)
    and the adapter (``eval.predict.adapter_tensors``) as arguments;
    ``predict.raw_parts(image_adapter, images, anchors, M)`` the form
    ``predict`` runs, outside inference mode. ``predict.mesh`` is None
    (the CLI's loader reads the global batch, as JAX's inputs are
    replicated); ``predict.pp_mesh`` is the pipeline's."""
    from aaclip_tpu_torch.eval.predict import _Graph

    if policy.bf16_until:
        raise ValueError("pipeline parallelism does not support the "
                         "staged-precision (bf16_until) trunk")
    if policy.quant_int8:
        raise ValueError("pipeline parallelism does not support the int8 "
                         "quantized trunk")
    _validate(cfg, acfg, pp)
    if img_size is not None and img_size != cfg.vision.image_size:
        raise ValueError(f"img_size {img_size} does not match the config's "
                         f"{cfg.vision.image_size} (use get_config(name, "
                         f"img_size))")
    n_micro = n_micro or pp
    mesh = _mesh_for(pp, dp, mesh, device)
    dev, s = mesh.device, mesh.stage_rank
    plan = _Plan(cfg, acfg, pp, s)
    v = cfg.vision
    grid, n_lev = v.grid, len(acfg.levels)
    S = grid * grid + 1
    visual = cast_matmul_weights(_stage_split(vit, plan.lo, plan.hi, dev),
                                 policy)
    act = L.config_act(cfg, policy)
    hops = _Hops(mesh)
    pp_prec = "highest" if policy.precision == "highest" else "high"
    E = cfg.embed_dim

    def body(g, images, anchors, M):
        """The rank's rows -> their maps and scores."""
        _check_adapters(g.adapter, acfg.image_adapt_until)
        b = images.shape[0]
        q_parts, det_parts = [], []
        img_mb = _microbatches(images, n_micro) if plan.first else None
        anc_mb = _microbatches(anchors, n_micro) if anchors.dim() == 3 \
            else None
        bm = b // n_micro
        for m in range(n_micro):
            if plan.first:
                x = embed(g.visual, cfg, img_mb[m], policy)
            else:
                x = hops.recv((bm, S, v.width), policy.compute_dtype, s - 1)
            taps = _taps(x, plan, g.visual, cfg, acfg, g.adapter, act=act,
                         policy=policy, attn_fn=attn_fn)
            if not plan.last:
                hops.send(taps[-1], s + 1)
            seg, det = _heads(taps, plan, g.visual, g.adapter, acfg, policy)
            a = anchors if anc_mb is None else anc_mb[m]
            scores = level_scores(seg, a)
            q_parts.append((scores[..., 1] - scores[..., 0]).sum(0) * 0.5)
            det_parts.append(det if det is not None
                             else torch.zeros((bm, E), device=dev))
        q = torch.cat(q_parts).reshape(b, -1)
        flat = sh.all_reduce(torch.cat([q, torch.cat(det_parts)], 1),
                             mesh.stage)
        q = (flat[:, :grid * grid] + n_lev * 0.5).reshape(b, grid, grid)
        return (apply_postproc_matrix(q, M, pp_prec),
                image_score(flat[:, grid * grid:], anchors))

    def bind(image_adapter):
        return SimpleNamespace(visual=visual, adapter=image_adapter)

    def rows(images, anchors):
        B = images.shape[0]
        _batch_error(B, n_micro, dp)
        data = mesh if dp > 1 else None
        # only the first stage embeds: the others never read the images
        images = sh.shard_rows(images, data, dev if plan.first else None)
        anchors = torch.as_tensor(anchors)
        anchors = sh.shard_rows(anchors, data, dev) if anchors.dim() == 3 \
            else anchors.to(dev)
        return images, anchors

    def gather(x):
        return sh.gather_rows(x, mesh if dp > 1 else None)

    def raw_parts(image_adapter, images, anchors, M):
        images, anchors = rows(torch.as_tensor(images), anchors)
        pix, score = body(bind(image_adapter), images, anchors,
                          torch.as_tensor(M, device=dev))
        return gather(pix), gather(score)

    @torch.inference_mode()
    def predict(image_adapter, images, anchors, M):
        return raw_parts(image_adapter, images, anchors, M)

    with torch.device("meta"):
        template = ImageAdapter(cfg, acfg)

    def graph_fn(g, images, anchors, M):
        images, anchors = rows(images, anchors)
        pix, score = body(g, images, anchors, M.to(dev))
        return gather(pix), gather(score)

    graph = _Graph(visual, template, None, graph_fn)

    def raw(visual_tensors: dict, adapter_tensors: dict, images, anchors,
            M):
        tensors = dict(visual_tensors)
        tensors.update((f"adapter.{k}", t)
                       for k, t in adapter_tensors.items())
        return torch.func.functional_call(graph, tensors,
                                          (images, anchors, M))

    named = {**dict(graph.named_parameters()), **dict(graph.named_buffers())}
    predict.visual = {k: named[k] for k in sorted(named)
                      if not k.startswith("adapter.")}
    predict.raw, predict.raw_parts = raw, raw_parts
    predict.device, predict.mesh, predict.pp_mesh = dev, None, mesh
    predict.pp, predict.dp, predict.n_micro = pp, dp, n_micro
    predict.stage_blocks = (plan.lo, plan.hi)
    return predict


def make_pp_stage1_features_fn(vit: VisionTransformer, cfg: CLIPConfig, *,
                               pp: int, n_micro: Optional[int] = None,
                               dp: int = 1, surgery_until_layer: int = 20,
                               policy: DtypePolicy = DtypePolicy(),
                               attn_fn=None, vv_attn_fn=None,
                               vv_mode: str = "batch",
                               mesh: Optional[PipeMesh] = None,
                               device=None) -> Callable:
    """The pipeline drop-in for ``train.steps.stage1_features_fn``:
    ``features(images, valid=None) -> [B, n_patches, embed_dim]`` on the
    global batch, returned on every rank (the stage-1 text step runs
    whole on each).

    The stream is two streams from the V-V start on: blocks [0,
    ``vv_start``) are shared by the surgery and the frozen tower, then the
    V-V tail and the standard tail part. The V-V start may fall inside a
    stage; a hop carries one stream before it and both after it. The last
    stage computes the head (ln_post, ``proj``, L2) and broadcasts the
    features over its replica (a slice of the last stage, not a sum,
    since they are activation-sized); the data axis gathers the replicas'
    rows.

    ``vv_mode="batch"`` couples the V-V softmax across each MICROBATCH's
    samples (the features equal the single-process batch mode run on
    each microbatch slice; ``n_micro=1`` recovers full-batch coupling),
    ``valid`` masking its pad rows; it refuses ``dp > 1`` and a custom
    ``vv_attn_fn``. ``vv_mode="spatial"`` is per-sample and exact at any
    (``n_micro``, ``dp``), its V-V blocks on ``vv_attn_fn`` (default the
    packed kernel's V-V mode)."""
    policy = policy.unstaged()  # staging is inference-only
    v = cfg.vision
    heads = v.heads
    if pp < 2:
        raise ValueError(f"pipeline_parallel={pp} needs >= 2 stages")
    if v.layers % pp:
        raise ValueError(
            f"pipeline_parallel={pp} must divide the {v.layers}-layer "
            "tower (stage-1 has no tap constraint, but stages must be "
            "equal-sized)")
    if vv_mode not in ("batch", "spatial"):
        raise ValueError(
            f"vv_mode must be 'batch' or 'spatial', got {vv_mode!r}")
    if vv_mode == "batch":
        if vv_attn_fn is not None:
            raise ValueError(
                "a custom vv_attn_fn requires vv_mode='spatial': the "
                "default batch mode installs the reference-exact "
                "batch-coupled kernel and would silently replace yours")
        if dp > 1:
            raise ValueError(
                "vv_mode='batch' does not compose with dp > 1: the "
                "batch-coupled V-V softmax would couple within each data "
                "shard only; use vv_mode='spatial' or dp=1 (plain "
                "data-parallel stage-1 — stage1_features_fn with a data "
                "mesh — handles batch mode)")
    n_micro = n_micro or pp
    mesh = _mesh_for(pp, dp, mesh, device, idle_ok=True)
    dev = mesh.device
    S, E = v.grid * v.grid + 1, vit.proj.shape[-1]
    # ranks outside the mesh (the world is larger than pp * dp) take the
    # features from the lead replica's last stage, so that every rank of
    # the world can run the replicated text step
    spectators = dist.get_world_size() > pp * dp
    if not mesh.active:
        def spectate(images, valid=None):
            feats = torch.empty((len(images), S - 1, E), device=dev)
            dist.broadcast(feats, pp - 1)
            return feats

        spectate.pp, spectate.dp, spectate.n_micro = pp, dp, n_micro
        spectate.vv_mode = vv_mode
        return spectate
    s = mesh.stage_rank
    ls = v.layers // pp
    lo, hi = s * ls, (s + 1) * ls
    vv_start = L.surgery_vv_start(v.layers, surgery_until_layer)
    tower = cast_block_matrices(_stage_split(vit, lo, hi, dev), policy)
    act = L.config_act(cfg, policy)
    hops = _Hops(mesh)
    D, cd = v.width, policy.compute_dtype

    def two(boundary):
        """Whether the hop into the stage starting at ``boundary`` carries
        both streams (the V-V tail has begun)."""
        return boundary > vv_start

    def run(x, start, stop, vv=False, vv_fn=None):
        for i in range(start, stop):
            x = L.residual_block(x, tower.blocks[i - lo], heads, vv=vv,
                                 act=act, policy=policy, attn_fn=attn_fn,
                                 vv_attn_fn=vv_fn)
        return x

    def project(t):
        t = L.layer_norm(t, tower.ln_post.weight, tower.ln_post.bias)
        return L.matmul(t.to(cd), tower.proj.to(cd), policy.precision)

    def stage(streams, vv_fn):
        """(shared,) or (vv, standard) streams -> the same after this
        stage's blocks."""
        if len(streams) == 1:
            x = run(streams[0], lo, min(hi, vv_start))
            if hi <= vv_start:
                return (x,)
            hv = hs = x
            start = max(lo, vv_start)
        else:
            (hv, hs), start = streams, lo
        return (run(hv, start, hi, vv=True, vv_fn=vv_fn),
                run(hs, start, hi))

    @torch.no_grad()
    def local(images, valid):
        b = images.shape[0]
        bm = b // n_micro
        img_mb = _microbatches(images, n_micro) if s == 0 else None
        val_mb = None if valid is None else _microbatches(valid, n_micro)
        out = []
        for m in range(n_micro):
            if s == 0:
                streams = (embed(tower, cfg, img_mb[m], policy),)
            else:
                streams = tuple(hops.recv((bm, S, D), cd, s - 1)
                                for _ in range(2 if two(lo) else 1))
            vv_fn = vv_attn_fn if vv_mode == "spatial" else \
                L.make_batch_vv_attn_fn(
                    heads, policy, None if val_mb is None else val_mb[m])
            streams = stage(streams, vv_fn)
            if s < pp - 1:
                for t in streams:
                    hops.send(t, s + 1)
            else:
                hv, hs = streams if len(streams) == 2 else streams * 2
                feats = project(hv[:, 1:, :])
                cls = L.l2_normalize(project(hs[:, 0, :]))
                out.append(L.l2_normalize(feats) + cls[:, None, :])
        feats = torch.cat(out) if out else \
            torch.empty((b, S - 1, E), device=dev)
        dist.broadcast(feats, mesh.peer(pp - 1), group=mesh.stage)
        return feats

    def features(images, valid=None):
        images = torch.as_tensor(images)
        _batch_error(images.shape[0], n_micro, dp)
        data = mesh if dp > 1 else None
        if valid is not None:
            valid = sh.shard_rows(torch.as_tensor(valid).float(), data, dev)
        feats = sh.gather_rows(
            local(sh.shard_rows(images, data, dev if s == 0 else None),
                  valid), data)
        if spectators:
            dist.broadcast(feats, pp - 1)
        return feats

    features.pp, features.dp, features.n_micro = pp, dp, n_micro
    features.vv_mode = vv_mode
    return features


def make_pp_stage2_step(vit: VisionTransformer, cfg: CLIPConfig,
                        acfg: AdapterConfig,
                        optimizer: tuple[torch.optim.Optimizer,
                                         torch.optim.lr_scheduler.
                                         LRScheduler],
                        anchors_table, *, pp: int,
                        n_micro: Optional[int] = None, dp: int = 1,
                        img_size: int | None = None,
                        policy: DtypePolicy = DtypePolicy(), attn_fn=None,
                        remat: bool = True,
                        mesh: Optional[PipeMesh] = None,
                        device=None) -> Callable:
    """The pipeline drop-in for ``train.steps.make_stage2_step``:
    ``step(image_adapter, images, mask, label, class_idx, valid) ->
    loss`` on the global batch, one update of the parameters that
    ``optimizer`` (the ``(optimizer, scheduler)`` pair of
    ``train/optim.py::make_image_optimizer``) holds, then one step of its
    schedule.

    The stage-2 loss adds up over the levels (CE on the det token plus
    each level's seg loss), so each stage computes its own levels' terms
    (and the last stage the CE) on every microbatch; autograd runs back
    through the hops, each stage sending the gradient of its input
    stream to the previous one. One update equals the single-process step
    with ``grad_accum = n_micro``: the loss and the gradient are the mean
    over the LIVE microbatches (those with a valid sample), each term a
    mean over its microbatch's global valid count (the numerators summed
    over the data axis, as JAX's ``psum``\\ s are).

    Each rank's backward reaches only the adapters of its stage (its
    layer adapters, seg projections and, on the last stage, the det
    projection); the gradients are then summed over the stage and the
    data groups, so every rank holds the whole gradient and takes the
    same Adam update, as JAX's replicated update does, and the lead rank
    holds the whole adapter and its optimizer state for the checkpoints.
    ``remat`` True checkpoints each block (``jax.checkpoint`` in JAX),
    False keeps the activations; "selective" is refused, as by JAX.
    ``attn_fn=None`` means the differentiable packed-attention kernels.
    """
    from aaclip_tpu_torch.train.steps import _no_int8, _Rows

    if isinstance(remat, str):
        raise ValueError(
            f"make_pp_stage2_step supports remat=True/False only, got "
            f"{remat!r} (selective remat is a make_stage2_step feature; "
            "the pipeline trainer recomputes whole blocks)")
    _no_int8(policy)
    policy = policy.unstaged()
    _validate(cfg, acfg, pp)
    n_micro = n_micro or pp
    mesh = _mesh_for(pp, dp, mesh, device)
    dev, s = mesh.device, mesh.stage_rank
    plan = _Plan(cfg, acfg, pp, s)
    v = cfg.vision
    img = img_size or v.image_size
    S = v.grid * v.grid + 1
    tower = cast_block_matrices(_stage_split(vit, plan.lo, plan.hi, dev),
                                policy)
    act = L.config_act(cfg, policy)
    if attn_fn is None:
        attn_fn = make_attn_fn(v.heads, policy, differentiable=True)
    anchors = torch.as_tensor(anchors_table, dtype=torch.float32, device=dev)
    optimizer, scheduler = optimizer
    params = [p for group in optimizer.param_groups for p in group["params"]]
    hops = _Hops(mesh)
    data = mesh if dp > 1 else None
    rows = _Rows(data, dev, n_micro)
    # the stream after block 0 carries a gradient when any block adapts
    grad_hops = acfg.image_adapt_until > 0

    def loss_terms(adapter, taps, mask, label, class_idx, valid, n):
        seg, det = _heads(taps, plan, tower, adapter, acfg, policy)
        banchors = anchors[class_idx]                        # [b, D, 2]
        loss = torch.zeros((), device=dev)
        if det is not None:
            logits = L.matmul(det[:, None, :], banchors,
                              policy.precision)[:, 0]
            loss = LL.cross_entropy_logits_masked(logits, label, valid, n)
        scores = level_scores(seg, banchors)
        for k in range(scores.shape[0]):
            d = train_similarity_logit(scores[k], img)
            loss = loss + LL.seg_loss_from_logit_masked(
                d, mask, valid, n, constant=rows.lead)
        return loss

    def step(adapter, images, mask, label, class_idx, valid):
        _check_adapters(adapter, acfg.image_adapt_until)
        B = images.shape[0]
        _batch_error(B, n_micro, dp)
        images, mask, label, class_idx, valid = (
            sh.shard_rows(torch.as_tensor(t), data, dev)
            for t in (images, mask, label, class_idx, valid))
        label, class_idx, valid = label.long(), class_idx.long(), \
            valid.float()
        counts = rows.counts(valid)
        b = images.shape[0]
        bm = b // n_micro
        mb = [_microbatches(t, n_micro)
              for t in (images, mask, label, class_idx, valid)]
        optimizer.zero_grad(set_to_none=True)
        kept, loss_sum = [], torch.zeros((), device=dev)
        for m in range(n_micro):
            if plan.first:
                x_in = embed(tower, cfg, mb[0][m], policy)
            else:
                x_in = hops.recv((bm, S, v.width), policy.compute_dtype,
                                 s - 1)
                x_in.requires_grad_(grad_hops)
            taps = _taps(x_in, plan, tower, cfg, acfg, adapter, act=act,
                         policy=policy, attn_fn=attn_fn, remat=remat)
            if not plan.last:
                hops.send(taps[-1], s + 1)
            loss = loss_terms(adapter, taps, mb[1][m], mb[2][m], mb[3][m],
                              mb[4][m], counts[m].clamp_min(1.0))
            # an all-padding microbatch has zero gradient but a dice term
            # of 2 per level: gated out of the loss and the mean
            loss_sum = loss_sum + (counts[m] > 0).float() * loss.detach()
            kept.append((x_in, taps[-1], loss))
        for m, (x_in, x_out, loss) in enumerate(kept):
            if not plan.last and grad_hops:
                g = hops.recv(x_out.shape, x_out.dtype, s + 1)
                torch.autograd.backward([loss, x_out],
                                        [torch.ones_like(loss), g])
            else:
                loss.backward()
            if not plan.first and grad_hops:
                hops.send(x_in.grad, s - 1)
        del kept
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sh.all_reduce_grads(params, mesh.stage)
        rows.reduce_grads(params)
        n_live = (counts > 0).float().sum().clamp_min(1.0)
        for p in params:
            p.grad.div_(n_live)
        optimizer.step()
        scheduler.step()
        return rows.total(sh.all_reduce(loss_sum, mesh.stage)) / n_live

    step.pp, step.dp, step.n_micro = pp, dp, n_micro
    return step


def cli_pp_mesh(pipeline_parallel: int, data_parallel: bool,
                tensor_parallel: int, sequence_parallel: bool,
                device=None) -> PipeMesh:
    """The CLIs' pipeline mesh, with the JAX CLIs' rules: pipeline
    parallelism excludes tensor and sequence parallelism, may not exceed
    the devices (here the world, one process per card, a world of one
    without ``torchrun``), and ``--data_parallel`` makes the data axis
    ``world // pp``."""
    if tensor_parallel > 1:
        raise SystemExit("--pipeline_parallel is mutually exclusive with "
                         "--tensor_parallel")
    if sequence_parallel:
        raise SystemExit("--sequence_parallel requires --tensor_parallel "
                         "and does not compose with --pipeline_parallel")
    sh.initialize_multihost(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if pipeline_parallel > n:
        raise SystemExit(f"--pipeline_parallel {pipeline_parallel} exceeds "
                         f"the {n} available devices")
    dp = n // pipeline_parallel if data_parallel else 1
    return make_pp_mesh(pipeline_parallel, dp, device=device)

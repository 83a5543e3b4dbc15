"""The training steps of both stages (the JAX package's
``aaclip_tpu/train/steps.py``).

Stage 1 (reference train.py:38-114): the text adapters train against a
pixel segmentation loss on frozen CLIP-Surgery patch features.
``stage1_features_fn`` computes those features without gradients;
``make_stage1_step`` encodes every prompt sentence through the adapted
text tower, reduces them to anchors and updates the text adapters. The
reference's per-level loop overwrites its loss, so only the last level
counts, and the orthogonality term is added once.

Stage 2 (reference train.py:117-174): the text anchors are frozen and
given as a table; the image adapters train with cross-entropy on the
detection token plus the seg loss summed over the tapped levels, through
the frozen trunk.

Batches carry a validity mask, so a padded final batch keeps the loss of
the exact batch. Gradients reach the adapters only: the towers' weights
do not require grad, so the backward forms no weight gradient for them.
Both steps keep the towers' parameters fp32 as stored, as JAX's steps do
(``core/params.py::cast_block_matrices`` pre-casts only the blocks' matmul
weights).

On a mesh (``parallel/sharding.py``) each function takes this data
rank's rows of the global batch, as the training CLI's loader reads them
(``sharding.shard_rows``: rows r, r + dp, ... of each global batch, as
JAX's per-host loaders deal them), and returns the rank's part: the
features of its rows, the global loss (``_Rows``). The loss is JAX's
global-batch loss: every masked mean divides by the global valid
count, dice's constant terms count once, the orthogonality term squares
the global mean, and each rank's share of it carries the gradient of its
own samples (``_Rows.loss_terms``). The adapters' gradients are summed
over the data axis after the backward (and, under sequence parallelism,
the per-block adapters' over the model axis too), so every rank takes the
same Adam update and the adapters stay replicated. A mesh with a model
axis Megatron-shards the frozen towers (``parallel/tensor.py``): the
vision trunk in stage 2 and the stage-1 features, the text tower in the
stage-1 step.
"""

from __future__ import annotations

from typing import Callable

import torch

from aaclip_tpu_torch.core.config import AdapterConfig, CLIPConfig, DtypePolicy
from aaclip_tpu_torch.core.params import cast_block_matrices
from aaclip_tpu_torch.device import resolve_device
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.models.text_model import (TextAdapter, TextTransformer,
                                                adapted_encode_text)
from aaclip_tpu_torch.models.vit import (VisionTransformer, adapted_forward,
                                         embed, run_blocks)
from aaclip_tpu_torch.ops import losses as LL
from aaclip_tpu_torch.ops.attention import make_attn_fn
from aaclip_tpu_torch.ops.similarity import (level_scores,
                                             train_similarity_logit)
from aaclip_tpu_torch.parallel import sharding as sh
from aaclip_tpu_torch.parallel import tensor as tpar
from aaclip_tpu_torch.text.anchors import reduce_to_anchors


def _check_mesh(mesh, sequence_parallel: bool) -> None:
    if sequence_parallel and not sh.is_tp_mesh(mesh):
        raise ValueError("sequence_parallel requires a 2-D mesh with "
                         "model-parallel size > 1 (make_mesh_2d)")


def _tower(tower, heads: int, mesh, sequence_parallel: bool):
    """The tower a step runs: this rank's shard on a mesh with a model
    axis (``vit`` may then live on the CPU), else ``tower``."""
    if sh.is_tp_mesh(mesh):
        return tpar.shard_tower(tower, heads, mesh, sequence_parallel)
    return tower


class _Rows:
    """A rank's part of a step's global batch, split into ``micro``
    microbatches. The step is given the rank's rows (``sharding.
    shard_rows``: global rows r, r + dp, ..., which its loader read), so
    its local microbatch k, rows [k b/micro, (k+1) b/micro) of its b, is
    its share of global microbatch k, rows [k B/micro, (k+1) B/micro) (JAX
    reshapes the global batch into microbatches before GSPMD shards
    them). Without a mesh it is the whole batch."""

    def __init__(self, mesh, device, micro: int = 1):
        self.mesh, self.device, self.micro = mesh, device, micro
        self.lead = mesh is None or mesh.data_rank == 0

    def take(self, x) -> torch.Tensor:
        """The rank's rows, as given, on the step's device."""
        return torch.as_tensor(x).to(self.device)

    def counts(self, valid: torch.Tensor) -> torch.Tensor:
        """Each microbatch's valid count over the global batch."""
        c = valid.float().reshape(self.micro, -1).sum(1)
        return c if self.mesh is None else sh.all_reduce(c, self.mesh.data)

    def orth_reduce(self):
        """The orthogonality numerator's sum over the data axis (identity
        backward: each rank's gradient reaches its own samples)."""
        if self.mesh is None:
            return None
        return lambda t: sh.reduce_from(t, self.mesh.data)

    def share(self, term: torch.Tensor) -> torch.Tensor:
        """A global term every rank computes whole (the squared mean):
        counted once in the loss's value, its gradient kept on every
        rank."""
        return term if self.lead else term - term.detach()

    def total(self, loss: torch.Tensor) -> torch.Tensor:
        """The global loss from the ranks' shares."""
        return loss if self.mesh is None else \
            sh.all_reduce(loss, self.mesh.data)

    def reduce_grads(self, params, sp_params=()) -> None:
        if self.mesh is None:
            return
        sh.all_reduce_grads(params, self.mesh.data)
        if sp_params:
            sh.all_reduce_grads(sp_params, self.mesh.model)


def _no_int8(policy: DtypePolicy) -> None:
    if policy.quant_int8:
        raise ValueError("--precision int8 is inference-only: the training "
                         "steps never quantize (the JAX package's steps and "
                         "train.py refuse it too)")


def _step_device(tower: torch.nn.Module, device, mesh=None) -> torch.device:
    """The step's device (``None`` is the card; on a mesh, the mesh's); the
    tower must live there, or, on a mesh with a model axis, may live on
    the CPU. On the card TF32 is switched off, so fp32 products are true
    fp32."""
    if mesh is not None and device is not None \
            and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    param_dev = next(tower.parameters()).device
    if param_dev.type != dev.type and not (sh.is_tp_mesh(mesh)
                                           and param_dev.type == "cpu"):
        raise ValueError(f"the tower lives on {param_dev}, step built for "
                         f"{dev}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


# ---------------------------------------------------------------------------
# Stage 1


def stage1_features_fn(vit: VisionTransformer, cfg: CLIPConfig, *,
                       surgery_until_layer: int = 20,
                       policy: DtypePolicy = DtypePolicy(), attn_fn=None,
                       vv_attn_fn=None, vv_mode: str = "batch",
                       chunk: int | None = None, mesh=None,
                       sequence_parallel: bool = False,
                       device=None) -> Callable:
    """``features(images, valid=None) -> [B, num_patches, embed_dim]``
    fp32: the gradient-free stage-1 supervision, the L2-normalised last
    level of the surgery tower's patch embeddings plus the frozen tower's
    normalised CLS embedding (reference train.py:74-85).

    The reference runs two whole towers, a surgery copy and the original.
    Surgery only rewires blocks ``vv_start..layers-1``, so the prefix of
    blocks ``[0, vv_start)`` is computed once and branches into the V-V
    tail (patch features) and the standard tail (CLS token).

    ``attn_fn`` (standard blocks) defaults to the packed-attention kernel
    (``layers.residual_block``'s default hook). ``vv_mode="batch"`` (default) is the reference-exact form, whose V-V
    blocks attend across the batch at each position
    (``layers.attention_vv_batch``, plain on every device); ``valid``
    masks a padded final batch's samples out of that softmax, and a custom
    ``vv_attn_fn`` is refused. ``vv_mode="spatial"`` is per-sample V-V
    attention through ``vv_attn_fn``, by default the packed kernel's V-V
    mode (the block's default V-V hook). ``chunk=N`` (spatial only: batch-mode features are coupled
    across the batch) extracts N images at a time, which is exact.

    ``device=None`` means the card; ``vit`` must live there. On a mesh the
    rank's rows go in (``sharding.shard_rows``) and their features come
    out; the batch-mode V-V softmax then runs over the global batch (the
    values and ``valid`` all-gathered over the data axis,
    ``layers.attention_vv_batch``), so the features equal the
    single-process ones up to the order of that softmax's sums, and
    ``device`` is the mesh's."""
    _check_mesh(mesh, sequence_parallel)
    _no_int8(policy)
    if chunk is not None and chunk < 1:
        raise ValueError(f"feature chunk must be >= 1, got {chunk}")
    if vv_mode not in ("batch", "spatial"):
        raise ValueError(f"vv_mode must be 'batch' or 'spatial', got "
                         f"{vv_mode!r}")
    if chunk and vv_mode != "spatial":
        raise ValueError(
            "feature chunking requires vv_mode='spatial': batch-mode "
            "surgery features are batch-coupled (the reference's V-V "
            "layout quirk), so chunked extraction would change them")
    if vv_mode == "batch" and vv_attn_fn is not None:
        raise ValueError(
            "a custom vv_attn_fn requires vv_mode='spatial': batch mode "
            "installs the reference-exact batch-coupled attention")
    dev = _step_device(vit, device, mesh)
    # staging (bf16_until) is an inference-path feature: the supervision
    # features keep the policy's uniform precision, as JAX's do
    policy = policy.unstaged()
    visual = cast_block_matrices(
        _tower(vit, cfg.vision.heads, mesh, sequence_parallel), policy)
    rows = _Rows(mesh, dev)
    data_group = mesh.data if mesh is not None else None
    act = L.config_act(cfg, policy)
    heads, layers = cfg.vision.heads, cfg.vision.layers
    vv_start = L.surgery_vv_start(layers, surgery_until_layer)
    cd = policy.compute_dtype

    def project(t):
        t = L.layer_norm(t, visual.ln_post.weight, visual.ln_post.bias)
        return L.matmul(t.to(cd), visual.proj.to(cd), policy.precision)

    @torch.no_grad()
    def run(images, vv_fn):
        x = L.stream_split(visual, embed(visual, cfg, images, policy))
        x = run_blocks(x, visual, cfg, 0, vv_start, act=act, policy=policy,
                       attn_fn=attn_fn)
        xs = run_blocks(x, visual, cfg, vv_start, layers, vv=True, act=act,
                        policy=policy, attn_fn=attn_fn, vv_attn_fn=vv_fn)
        feats = project(L.stream_gather(visual, xs)[:, 1:, :])
        del xs
        xc = run_blocks(x, visual, cfg, vv_start, layers, act=act,
                        policy=policy, attn_fn=attn_fn)
        cls = L.l2_normalize(project(L.stream_gather(visual, xc)[:, 0, :]))
        return L.l2_normalize(feats) + cls[:, None, :]

    def local(images, valid):
        if vv_mode == "spatial":
            if not chunk or images.shape[0] <= chunk:
                return run(images, vv_attn_fn)
            return torch.cat([run(images[i:i + chunk], vv_attn_fn)
                              for i in range(0, images.shape[0], chunk)])
        return run(images, L.make_batch_vv_attn_fn(heads, policy, valid,
                                                   data_group))

    def features(images, valid=None):
        images = rows.take(images)
        if valid is not None:
            valid = rows.take(valid)
        return local(images, valid)

    return features


def make_stage1_step(text: TextTransformer, cfg: CLIPConfig,
                     acfg: AdapterConfig, optimizer: torch.optim.Optimizer,
                     prompt_tokens, *, text_norm_weight: float = 0.1,
                     img_size: int | None = None,
                     policy: DtypePolicy = DtypePolicy(),
                     remat: bool | str = True, mesh=None,
                     sequence_parallel: bool = False,
                     device=None) -> Callable:
    """``step(text_adapter, feats, mask, class_idx, valid) -> loss``: one
    update of the text-adapter parameters that ``optimizer`` holds
    (``train/optim.py::make_text_optimizer``, a constant LR).

    ``prompt_tokens`` [n_classes, 16, 77] are every prompt sentence of the
    training dataset's classes; each step encodes all of them through the
    adapted text tower (``remat``: True checkpoints each block,
    "selective" keeps JAX's named tensors, ``models/text_model.py``),
    reduces them to
    [n_classes, D, 2] anchors and takes each sample's by ``class_idx``.
    ``feats`` [B, L, D] come from ``stage1_features_fn``; mask [B, H, W],
    class_idx and valid [B]. The loss is the seg loss of ``100 * feats .
    anchors`` (fp32, TF32 off) plus ``text_norm_weight`` times the
    anchors' orthogonality loss; a device tensor, not synchronised.

    ``device=None`` means the card; ``text`` and the adapter must live
    there. On a mesh the step takes the rank's rows of the global batch
    (``sharding.shard_rows``; its features as ``stage1_features_fn`` gives
    them) and returns JAX's global loss; every rank encodes every prompt (the prompt batch is
    replicated over the data axis, which JAX's batch constraint only
    spreads), the text tower Megatron-sharded over a model axis."""
    _check_mesh(mesh, sequence_parallel)
    _no_int8(policy)
    dev = _step_device(text, device, mesh)
    policy = policy.unstaged()  # staging is inference-only
    img = img_size or cfg.vision.image_size
    tokens = torch.as_tensor(prompt_tokens, device=dev).long()
    C, S, _ = tokens.shape
    flat_tokens = tokens.reshape(C * S, -1)
    text_w = cast_block_matrices(
        _tower(text, cfg.text.heads, mesh, sequence_parallel), policy)
    rows = _Rows(mesh, dev)

    def loss_fn(adapter: TextAdapter, feats, mask, class_idx, valid, n):
        embeds = adapted_encode_text(
            text_w, adapter, cfg, flat_tokens,
            text_adapt_weight=acfg.text_adapt_weight, policy=policy,
            remat=remat)
        anchors = reduce_to_anchors(embeds.reshape(C, S, -1))  # [C, D, 2]
        banchors = anchors[class_idx]                          # [B, D, 2]
        scores = 100.0 * torch.einsum("bld,bdk->blk", feats, banchors)
        d = train_similarity_logit(scores, img)
        seg = LL.seg_loss_from_logit_masked(d, mask, valid, n,
                                            constant=rows.lead)
        orth = rows.share(LL.orthogonality_loss_masked(
            banchors, valid, n, reduce=rows.orth_reduce()))
        return seg + text_norm_weight * orth

    def step(adapter, feats, mask, class_idx, valid):
        feats, mask, class_idx, valid = (
            rows.take(t) for t in (feats, mask, class_idx, valid))
        n = rows.counts(valid)[0].clamp_min(1.0)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(adapter, feats.float(), mask, class_idx.long(), valid,
                       n)
        loss.backward()
        rows.reduce_grads(
            [p for g in optimizer.param_groups for p in g["params"]],
            tpar.sp_trunk_params(adapter) if sequence_parallel else ())
        optimizer.step()
        return rows.total(loss.detach())

    return step


# ---------------------------------------------------------------------------
# Stage 2


def make_stage2_step(vit: VisionTransformer, cfg: CLIPConfig,
                     acfg: AdapterConfig,
                     optimizer: tuple[torch.optim.Optimizer,
                                      torch.optim.lr_scheduler.LRScheduler],
                     anchors_table, *, img_size: int | None = None,
                     policy: DtypePolicy = DtypePolicy(), attn_fn=None,
                     remat: bool | str = True, mesh=None,
                     sequence_parallel: bool = False, grad_accum: int = 1,
                     device=None) -> Callable:
    """``step(image_adapter, images, mask, label, class_idx, valid) ->
    loss``: one update of the adapter parameters that ``optimizer`` holds,
    then one step of its schedule. ``optimizer`` is the ``(optimizer,
    scheduler)`` pair that ``train/optim.py::make_image_optimizer``
    returns (the JAX step's optax transformation carries its schedule the
    same way). The loss is a device tensor, not synchronised.

    ``anchors_table`` is [n_classes, D, 2]; images [B, 3, H, W], mask
    [B, H, W], label, class_idx and valid [B]. ``attn_fn=None`` means the
    differentiable packed-attention kernels. ``remat`` checkpoints each
    block (True) or keeps JAX's selective set ("selective": no second
    attention forward; ``models/vit.py::trunk_taps``). ``grad_accum=K``
    splits the batch into K microbatches, sums their gradients and
    applies the mean over the live ones (those with a valid sample) once;
    the loss reported is the mean over live microbatches, as in the JAX
    package.

    ``device=None`` means the card and raises when there is none; ``vit``
    and the adapter must already live there. On a mesh the step takes the
    rank's rows of the global batch (``sharding.shard_rows``; every rank
    the same count, a multiple of ``grad_accum``) and returns JAX's global
    loss; a model axis shards the trunk, whose attention hook
    must then be a ``make_attn_fn`` one (the default)."""
    _check_mesh(mesh, sequence_parallel)
    _no_int8(policy)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dev = _step_device(vit, device, mesh)
    policy = policy.unstaged()  # staging is inference-only
    img = img_size or cfg.vision.image_size
    # fp32 biases and LayerNorm affines, as JAX's step keeps them
    # (train/steps.py:348); only the matmul weights are pre-cast
    visual = cast_block_matrices(
        _tower(vit, cfg.vision.heads, mesh, sequence_parallel), policy)
    rows = _Rows(mesh, dev, grad_accum)
    act = L.config_act(cfg, policy)
    if attn_fn is None:
        attn_fn = make_attn_fn(cfg.vision.heads, policy, differentiable=True)
    anchors = torch.as_tensor(anchors_table, dtype=torch.float32, device=dev)
    optimizer, scheduler = optimizer
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def loss_fn(adapter, images, mask, label, class_idx, valid, n):
        seg, det = adapted_forward(
            visual, adapter, cfg, images,
            image_adapt_weight=acfg.image_adapt_weight, levels=acfg.levels,
            proj_relu=acfg.proj_relu, policy=policy, act=act,
            attn_fn=attn_fn, remat=remat)
        banchors = anchors[class_idx]                       # [B, D, 2]
        logits = L.matmul(det[:, None, :], banchors,
                          policy.precision)[:, 0]
        loss = LL.cross_entropy_logits_masked(logits, label, valid, n)
        scores = level_scores(torch.stack(seg), banchors)   # [n, B, L, 2]
        for lvl in range(scores.shape[0]):
            d = train_similarity_logit(scores[lvl], img)
            loss = loss + LL.seg_loss_from_logit_masked(
                d, mask, valid, n, constant=rows.lead)
        return loss

    def step(adapter, images, mask, label, class_idx, valid):
        B = images.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch size {B} not divisible by "
                             f"grad_accum {grad_accum}")
        images, mask, label, class_idx, valid = (
            rows.take(t) for t in (images, mask, label, class_idx, valid))
        counts = rows.counts(valid)
        optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss = loss_fn(adapter, images, mask, label, class_idx, valid,
                           counts[0].clamp_min(1.0))
            loss.backward()
            loss = loss.detach()
        else:
            n = images.shape[0] // grad_accum
            loss_sum = torch.zeros((), device=dev)
            n_live = torch.zeros((), device=dev)
            for k in range(grad_accum):
                mb = slice(k * n, (k + 1) * n)
                l = loss_fn(adapter, images[mb], mask[mb], label[mb],
                            class_idx[mb], valid[mb],
                            counts[k].clamp_min(1.0))
                l.backward()  # gradients add up in .grad
                # an all-padding microbatch has zero gradient but a dice
                # term of 2 per level: gate it out of the loss and the mean
                live = (counts[k] > 0).float()
                loss_sum = loss_sum + live * l.detach()
                n_live = n_live + live
            n_live = n_live.clamp_min(1.0)
            loss = loss_sum / n_live
            for p in params:
                if p.grad is not None:
                    p.grad.div_(n_live)
        rows.reduce_grads(params, tpar.sp_trunk_params(adapter)
                          if sequence_parallel else ())
        optimizer.step()
        scheduler.step()
        return rows.total(loss)

    return step

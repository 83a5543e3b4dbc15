"""The stage-2 training step (the JAX package's
``aaclip_tpu/train/steps.py::make_stage2_step``, after the reference's
train.py:117-174): the text anchors are frozen and given as a table; the
image adapters train with cross-entropy on the detection token plus the
seg loss summed over the tapped levels, through the frozen trunk.

Batches carry a validity mask, so a padded final batch keeps the loss of
the exact batch. Gradients reach the adapters only: the trunk's weights
do not require grad, so the backward forms no weight gradient for them.
"""

from __future__ import annotations

from typing import Callable

import torch

from aaclip_tpu_torch.core.config import AdapterConfig, CLIPConfig, DtypePolicy
from aaclip_tpu_torch.core.params import cast_matmul_weights
from aaclip_tpu_torch.device import resolve_device
from aaclip_tpu_torch.models.layers import config_act
from aaclip_tpu_torch.models.vit import VisionTransformer, adapted_forward
from aaclip_tpu_torch.ops import losses as LL
from aaclip_tpu_torch.ops.attention import make_attn_fn
from aaclip_tpu_torch.ops.similarity import (level_scores,
                                             train_similarity_logit)


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
    block (``models/vit.py::trunk_taps``). ``grad_accum=K`` splits the
    batch into K microbatches, sums their gradients and applies the mean
    over the live ones (those with a valid sample) once; the loss reported
    is the mean over live microbatches, as in the JAX package.

    ``device=None`` means the card and raises when there is none; ``vit``
    and the adapter must already live there."""
    if mesh is not None or sequence_parallel:
        raise NotImplementedError(
            "meshes, tensor and sequence parallelism are not ported yet: "
            "ROADMAP A12, 'int8, mesh and serving'")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dev = resolve_device(device)
    param_dev = next(vit.parameters()).device
    if param_dev.type != dev.type:
        raise ValueError(f"vit lives on {param_dev}, step built for {dev}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    img = img_size or cfg.vision.image_size
    visual = cast_matmul_weights(vit, policy)
    act = config_act(cfg, policy)
    if attn_fn is None:
        attn_fn = make_attn_fn(cfg.vision.heads, policy, differentiable=True)
    anchors = torch.as_tensor(anchors_table, dtype=torch.float32, device=dev)
    optimizer, scheduler = optimizer
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def loss_fn(adapter, images, mask, label, class_idx, valid):
        seg, det = adapted_forward(
            visual, adapter, cfg, images,
            image_adapt_weight=acfg.image_adapt_weight, levels=acfg.levels,
            proj_relu=acfg.proj_relu, policy=policy, act=act,
            attn_fn=attn_fn, remat=remat)
        banchors = anchors[class_idx]                       # [B, D, 2]
        logits = torch.einsum("bd,bdk->bk", det, banchors)
        loss = LL.cross_entropy_logits_masked(logits, label, valid)
        scores = level_scores(torch.stack(seg), banchors)   # [n, B, L, 2]
        for lvl in range(scores.shape[0]):
            d = train_similarity_logit(scores[lvl], img)
            loss = loss + LL.seg_loss_from_logit_masked(d, mask, valid)
        return loss

    def step(adapter, images, mask, label, class_idx, valid):
        images, mask, label, class_idx, valid = (
            torch.as_tensor(t, device=dev)
            for t in (images, mask, label, class_idx, valid))
        optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss = loss_fn(adapter, images, mask, label, class_idx, valid)
            loss.backward()
            loss = loss.detach()
        else:
            B = images.shape[0]
            if B % grad_accum:
                raise ValueError(f"batch size {B} not divisible by "
                                 f"grad_accum {grad_accum}")
            n = B // grad_accum
            loss_sum = torch.zeros((), device=dev)
            n_live = torch.zeros((), device=dev)
            for k in range(grad_accum):
                mb = slice(k * n, (k + 1) * n)
                l = loss_fn(adapter, images[mb], mask[mb], label[mb],
                            class_idx[mb], valid[mb])
                l.backward()  # gradients add up in .grad
                # an all-padding microbatch has zero gradient but a dice
                # term of 2 per level: gate it out of the loss and the mean
                live = (valid[mb].sum() > 0).float()
                loss_sum = loss_sum + live * l.detach()
                n_live = n_live + live
            n_live = n_live.clamp_min(1.0)
            loss = loss_sum / n_live
            for p in params:
                if p.grad is not None:
                    p.grad.div_(n_live)
        optimizer.step()
        scheduler.step()
        return loss

    return step

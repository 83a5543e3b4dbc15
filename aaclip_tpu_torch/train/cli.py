"""Two-stage training CLI: ``python -m aaclip_tpu_torch.train``.

The JAX package's ``train.py`` (reference train.py:177-357) on the card:
stage 1 trains the text adapters against CLIP-Surgery patch features,
then the text anchors are encoded, then stage 2 trains the image adapters
through the frozen trunk. The towers come from an OpenAI-layout
checkpoint (or the seeded init, with a warning); each epoch writes
``text_adapter.npz`` (stage 1) or ``image_adapter.npz`` and
``image_adapter_{epoch}.npz`` (stage 2) with the Adam state in optax's
layout, so either package resumes the other's run; the log goes to
``{save_path}/train.log``.

The input path is the host's (``data/``: PNG decode, colour jitter and
the geometric augment in numpy threads, no PIL for PNG sets), or with
``--device_augment`` the geometric augment on the card, and with
``--cache_device`` the whole raw set on the card, each batch assembled
there (``data/device_cache.py``); ``--fused_assemble`` then assembles
batch k+1 on a second CUDA stream while step k runs. The host waits for a
loss only every ``--loss_fetch_every`` steps; ``--profile_input`` logs
where each epoch's host loop spent its time.

The flags are the JAX CLI's; those of paths not ported yet raise at parse
time naming their ROADMAP item. ``--remat auto`` resolves as JAX's does
(``resolve_remat``) and the log says to what. ``main(argv,
device="cpu")`` runs on the CPU (the tests); by default it runs on the
card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# flags of paths the port does not have yet -> (ROADMAP item, its title)
_A6 = ("A6", "the orbax checkpoint backend, JAX's own")
_A12 = ("A12", "int8, mesh and export")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Training")
    # model (reference train.py:180-188)
    parser.add_argument("--model_name", type=str, default="ViT-L-14-336")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--surgery_until_layer", type=int, default=20)
    parser.add_argument("--relu", action="store_true",
                        help="use relu after projection")
    # training (reference train.py:190-206)
    parser.add_argument("--dataset", type=str, default="VisA")
    parser.add_argument("--training_mode", type=str, default="few_shot",
                        choices=["few_shot", "full_shot"])
    parser.add_argument("--shot", type=int, default=32)
    parser.add_argument("--text_batch_size", type=int, default=16)
    parser.add_argument("--image_batch_size", type=int, default=2)
    parser.add_argument("--text_epoch", type=int, default=5)
    parser.add_argument("--image_epoch", type=int, default=20)
    parser.add_argument("--text_lr", type=float, default=0.00001)
    parser.add_argument("--image_lr", type=float, default=0.0005)
    parser.add_argument("--criterion", type=str, nargs="+",
                        default=["dice_loss", "focal_loss"],
                        help="accepted and ignored, as by the reference "
                             "(its loss is focal + dice)")
    # exp (reference train.py:208-209)
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--save_path", type=str, default="ckpt/baseline")
    # hyper-parameters (reference train.py:211-215)
    parser.add_argument("--text_norm_weight", type=float, default=0.1)
    parser.add_argument("--text_adapt_weight", type=float, default=0.1)
    parser.add_argument("--image_adapt_weight", type=float, default=0.1)
    parser.add_argument("--text_adapt_until", type=int, default=3)
    parser.add_argument("--image_adapt_until", type=int, default=6)
    # the JAX package's extras
    parser.add_argument("--levels", type=int, nargs="+",
                        default=[6, 12, 18, 24])
    parser.add_argument("--precision", type=str, default="fp32",
                        choices=["fp32", "fp32_high", "bf16"],
                        help="fp32 = true fp32 products (TF32 off); "
                             "fp32_high = 3-pass products (three bf16 "
                             "passes; training never stages blocks at "
                             "bf16); bf16 = the fast path")
    parser.add_argument("--clip_checkpoint", type=str, default=None)
    parser.add_argument("--require_pretrained", action="store_true")
    parser.add_argument("--ckpt_backend", type=str, default="npz",
                        choices=["npz", "orbax"])
    parser.add_argument("--device_augment", action="store_true",
                        help="the joint geometric augment on the card, "
                             "whole batch at once, from uint8 inputs; same "
                             "distribution, another random stream")
    parser.add_argument("--vv_mode", type=str, default="batch",
                        choices=["batch", "spatial"],
                        help="stage-1 V-V attention: 'batch' is the "
                             "reference's batch-coupled form (plain), "
                             "'spatial' the per-sample CLIP-Surgery form "
                             "on the attention kernel's V-V mode")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--data_parallel", action="store_true")
    parser.add_argument("--tensor_parallel", type=int, default=1)
    parser.add_argument("--sequence_parallel", action="store_true")
    parser.add_argument("--pipeline_parallel", type=int, default=1)
    parser.add_argument("--pp_microbatches", type=int, default=None)
    parser.add_argument("--cache_device", action="store_true",
                        help="with --device_augment: upload the raw uint8 "
                             "set to the card once and assemble each batch "
                             "there (gather, colour jitter, normalise, "
                             "geometric augment); needs n_images * 4 * "
                             "img_size^2 bytes of device memory")
    parser.add_argument("--fused_assemble", action="store_true",
                        help="with --cache_device: assemble stage 2's next "
                             "batch on a second CUDA stream while the step "
                             "runs (the same numbers)")
    parser.add_argument("--loss_fetch_every", type=int, default=8,
                        help="wait for a loss only every K steps (the rest "
                             "are read at epoch end); 1 waits every step")
    parser.add_argument("--profile_input", action="store_true",
                        help="log each epoch's host-loop phases (loader "
                             "wait, copy to the card, augment, step "
                             "dispatch, loss wait)")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="split each stage-2 batch into this many "
                             "microbatches, summing their gradients")
    parser.add_argument("--feature_chunk", type=int, default=0,
                        help="stage 1: extract the surgery features this "
                             "many images at a time (--vv_mode spatial "
                             "only)")
    parser.add_argument("--remat", type=str, default="auto",
                        choices=["auto", "full", "selective", "off"],
                        help="rematerialisation of the blocks: 'auto' is "
                             "'selective' for the text tower, and for "
                             "stage 2 'selective' on the card (the "
                             "attention kernels) and 'full' on the CPU")
    args = parser.parse_args(argv)
    # the JAX CLI's flag rules (train.py:186-198)
    if args.fused_assemble and not args.cache_device:
        parser.error("--fused_assemble requires --cache_device")
    if args.cache_device and not args.device_augment:
        parser.error("--cache_device requires --device_augment (batch "
                     "assembly, jitter and augmentation all run on device)")
    if args.cache_device and (args.tensor_parallel > 1
                              or args.pipeline_parallel > 1
                              or args.data_parallel):
        parser.error("--cache_device assembles single-device batches; it "
                     "does not compose with data/tensor/pipeline "
                     "parallelism")
    unported = [
        ("--data_parallel", args.data_parallel, _A12),
        ("--tensor_parallel", args.tensor_parallel > 1, _A12),
        ("--sequence_parallel", args.sequence_parallel, _A12),
        ("--pipeline_parallel", args.pipeline_parallel > 1, _A12),
        ("--pp_microbatches", args.pp_microbatches is not None, _A12),
        ("--ckpt_backend orbax", args.ckpt_backend == "orbax", _A6),
    ]
    for flag, given, (item, title) in unported:
        if given:
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP {item}, '{title}'")
    return args


def resolve_remat(flag: str, stage: int, device) -> bool | str:
    """The steps' ``remat`` for ``--remat`` at ``stage``, as the JAX CLI
    resolves it (``train.py:466-468, :515-520``): "auto" is "selective"
    for the text tower, whose saved tensors are context-length-sized; for
    stage 2 it is "selective" where the attention kernels run (the card;
    JAX: where its Pallas attention does) and full remat on the CPU, where
    the attention is the plain version (JAX: its XLA attention)."""
    if flag != "auto":
        return {"full": True, "selective": "selective", "off": False}[flag]
    if stage == 1 or device.type == "cuda":
        return "selective"
    return True


def _copy_into(module, source) -> None:
    """``module``'s parameters (held by its optimizer) take ``source``'s
    values."""
    import torch

    with torch.no_grad():
        for p, q in zip(module.parameters(), source.parameters()):
            p.copy_(q)


def main(argv=None, *, device=None):
    args = parse_args(argv)

    import torch

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              find_default_checkpoint,
                                              init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_from_jax,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.datasets import BatchLoader, get_train_datasets
    from aaclip_tpu_torch.data.registry import CLASS_NAMES
    from aaclip_tpu_torch.device import resolve_device
    from aaclip_tpu_torch.eval.predict import make_anchor_encoder
    from aaclip_tpu_torch.ops.augment import (augment_generator,
                                              make_device_augment)
    from aaclip_tpu_torch.text.anchors import (dataset_prompt_tokens,
                                               encode_dataset_anchors)
    from aaclip_tpu_torch.train import checkpoint as ckpt
    from aaclip_tpu_torch.train.optim import (make_image_optimizer,
                                              make_text_optimizer)
    from aaclip_tpu_torch.train.steps import (make_stage1_step,
                                              make_stage2_step,
                                              stage1_features_fn)
    from aaclip_tpu_torch.utils.logging import setup_logger
    from aaclip_tpu_torch.utils.profiling import (HostLoopProfiler,
                                                  StepTimer,
                                                  ThrottledLossDrain)
    from aaclip_tpu_torch.utils.seed import setup_seed

    dev = resolve_device(device)
    setup_seed(args.seed)
    os.makedirs(args.save_path, exist_ok=True)
    logger = setup_logger("aaclip.train",
                          os.path.join(args.save_path, "train.log"))
    logger.info("args: %s", vars(args))

    policy = DtypePolicy.from_name(args.precision)
    cfg = get_config(args.model_name, args.img_size)
    acfg = AdapterConfig(
        text_adapt_weight=args.text_adapt_weight,
        image_adapt_weight=args.image_adapt_weight,
        text_adapt_until=args.text_adapt_until,
        image_adapt_until=args.image_adapt_until,
        levels=tuple(args.levels),
        proj_relu=args.relu,
    )
    vit, text = create_clip_towers(
        cfg, checkpoint=args.clip_checkpoint, seed=args.seed,
        require_pretrained=args.require_pretrained, device=dev)
    if args.clip_checkpoint is None and find_default_checkpoint() is None:
        logger.warning("no CLIP checkpoint found — using RANDOM weights "
                       "(smoke/benchmark mode only)")
    image_adapter = init_image_adapter(cfg, acfg, seed=args.seed,
                                       device=dev)
    text_adapter = init_text_adapter(cfg, acfg, seed=args.seed + 1,
                                     device=dev)

    class_names = CLASS_NAMES[args.dataset]
    cls_to_idx = {c: i for i, c in enumerate(class_names)}
    prompt_tokens = dataset_prompt_tokens(args.dataset)

    if args.training_mode == "full_shot":
        args.shot = -1
    logger.info("loading dataset ...")
    text_ds, image_ds = get_train_datasets(
        args.dataset, args.img_size, args.shot, seed=args.seed,
        device_augment=args.device_augment)
    # the datasets emit uint8 under --device_augment; the card normalises
    aug_fn = make_device_augment(uint8_inputs=True) \
        if args.device_augment else None

    text_opt = make_text_optimizer(text_adapter.parameters(), args.text_lr)
    image_opt, image_sched = make_image_optimizer(
        image_adapter.parameters(), args.image_lr)

    def text_state():
        return ckpt.adam_state_tree(text_opt, text_adapter,
                                    text_adapter_to_jax)

    def image_state():
        return ckpt.adam_state_tree(image_opt, image_adapter, adapter_to_jax,
                                    image_sched)

    # ---- checkpoint resume (reference train.py:276-296 semantics) --------
    text_step = image_step = 0
    text_start_epoch = 0
    adapt_text = args.text_epoch != 0
    text_ckpt = os.path.join(args.save_path, "text_adapter.npz")
    found = ckpt.find_adapter_checkpoint(text_ckpt)
    if found:
        template = text_adapter_to_jax(text_adapter)
        opt_template = text_state()
        epoch, tree, text_step = ckpt.load_adapter_checkpoint_any(found,
                                                                  template)
        _copy_into(text_adapter,
                   text_adapter_from_jax(tree, cfg, acfg, device="cpu"))
        opt_tree = ckpt.load_optimizer_state(found, opt_template)
        if opt_tree is not None:
            ckpt.load_adam_state(
                text_opt, text_adapter, opt_tree,
                lambda t: text_adapter_from_jax(t, cfg, acfg, device="cpu"))
        text_start_epoch = epoch
        # the reference's quirk, kept: a run that stopped one epoch short
        # of text_epoch skips the text stage
        adapt_text = not (epoch == (args.text_epoch - 1))

    image_start_epoch = 0
    image_ckpt = os.path.join(args.save_path, "image_adapter.npz")
    found = ckpt.find_adapter_checkpoint(image_ckpt)
    if found:
        template = adapter_to_jax(image_adapter)
        opt_template = image_state()
        epoch, tree, image_step = ckpt.load_adapter_checkpoint_any(
            found, template)
        _copy_into(image_adapter,
                   adapter_from_jax(tree, cfg, acfg, device="cpu"))
        opt_tree = ckpt.load_optimizer_state(found, opt_template)
        if opt_tree is not None:
            ckpt.load_adam_state(
                image_opt, image_adapter, opt_tree,
                lambda t: adapter_from_jax(t, cfg, acfg, device="cpu"),
                image_sched)
        image_start_epoch = epoch

    remat = {stage: resolve_remat(args.remat, stage, dev)
             for stage in (1, 2)}
    logger.info("remat %s: stage 1 (text tower) %s, stage 2 %s", args.remat,
                *({True: "full", False: "off"}.get(remat[s], remat[s])
                  for s in (1, 2)))

    def device_batch(batch):
        """numpy batch -> (images, mask [B, H, W], label, class_idx,
        valid) on the card."""
        B = batch["image"].shape[0]
        return (torch.as_tensor(batch["image"], device=dev),
                torch.as_tensor(batch["mask"].reshape(B, args.img_size,
                                                      args.img_size),
                                device=dev),
                torch.as_tensor(batch["label"], device=dev).long(),
                torch.tensor([cls_to_idx[c] for c in batch["class_name"]],
                             device=dev),
                (torch.arange(B) < batch["n_valid"]).float().to(dev))

    def make_train_loader(ds, batch_size, text_stage, seed):
        """BatchLoader, or with --cache_device the set on the card.
        ``seed`` drives the shuffle (stage 2 uses seed + 1 in both)."""
        if args.cache_device:
            from aaclip_tpu_torch.data.device_cache import (DeviceCacheLoader,
                                                            cache_nbytes)
            logger.info("cache_device: uploading %d raw samples (~%.2f GB "
                        "uint8) to device memory", len(ds),
                        cache_nbytes(len(ds), args.img_size) / 1e9)
            return DeviceCacheLoader(ds, cls_to_idx, batch_size, seed,
                                     text_stage=text_stage,
                                     aug_seed=args.seed, device=dev,
                                     num_workers=args.num_workers)
        return BatchLoader(ds, batch_size, shuffle=True, seed=seed,
                           num_workers=args.num_workers)

    def prepare_batch(prof, batch, stage, epoch, it):
        """A loader batch -> five tensors on the card; cache batches come
        assembled."""
        if args.cache_device:
            images, mask, label, class_idx, valid = batch
            return images, mask, label.long(), class_idx.long(), valid
        with prof.phase("h2d"):
            images, mask, label, class_idx, valid = device_batch(batch)
        if aug_fn is not None:
            with prof.phase("augment_dispatch"):
                images, mask = aug_fn(
                    augment_generator(args.seed, stage, epoch, it, dev),
                    images, mask)
        return images, mask, label, class_idx, valid

    def run_epoch(loader, stage, epoch, update):
        """One epoch of ``update(images, mask, label, class_idx, valid) ->
        loss``; logs the loss, the rate and the host-loop profile."""
        timer = StepTimer()  # per epoch: the checkpoint save is outside
        prof = HostLoopProfiler(enabled=args.profile_input)
        drain = ThrottledLossDrain(args.loss_fetch_every)
        for it, batch in enumerate(prof.wrap(loader)):
            images, mask, label, class_idx, valid = \
                prepare_batch(prof, batch, stage, epoch, it)
            loss = update(prof, images, mask, label, class_idx, valid)
            with prof.phase("loss_fetch"):
                drain.append(loss)  # waits only every K steps
            timer.tick(images.shape[0])
        report_epoch(timer, prof, drain)

    def run_fused_epoch(loader, fused):
        """One stage-2 epoch of ``loader.make_fused_step``'s ``fused``:
        step k assembles batch k+1 beside it; the last step assembles step
        0's plan again and drops it, as the JAX CLI's loop does."""
        nonlocal image_step
        timer = StepTimer()
        prof = HostLoopProfiler(enabled=args.profile_input)
        drain = ThrottledLossDrain(args.loss_fetch_every)
        plan = loader.epoch_plan()
        batch = loader.assemble(plan[0][0], plan[0][1])
        valid = plan[0][2]
        for it in prof.wrap(range(len(plan))):
            nidx, ngen, nvalid = plan[(it + 1) % len(plan)]
            images, mask, label, class_idx = batch
            with prof.phase("step_dispatch"):
                loss, batch = fused(image_adapter, images, mask,
                                    label.long(), class_idx.long(), valid,
                                    nidx, ngen)
            image_step += 1
            valid = nvalid
            with prof.phase("loss_fetch"):
                drain.append(loss)
            timer.tick(images.shape[0])
        loader.advance_epoch()
        report_epoch(timer, prof, drain)

    def report_epoch(timer, prof, drain):
        losses = drain.drain()
        timer.stop()  # the losses are read: the card is idle
        logger.info("loss: %s", float(np.mean(losses)))
        logger.info("throughput: %.2f img/s", timer.rate())
        prof.report(logger)

    # ---- stage 1 ----------------------------------------------------------
    if adapt_text and text_start_epoch < args.text_epoch:
        feats_fn = stage1_features_fn(
            vit, cfg, surgery_until_layer=args.surgery_until_layer,
            policy=policy, vv_mode=args.vv_mode,
            chunk=args.feature_chunk or None, device=dev)
        step_fn = make_stage1_step(
            text, cfg, acfg, text_opt, prompt_tokens,
            text_norm_weight=args.text_norm_weight, img_size=args.img_size,
            policy=policy, remat=remat[1], device=dev)

        def update_text(prof, images, mask, label, class_idx, valid):
            nonlocal text_step
            # valid: a padded final batch must not leak its pad rows into
            # the batch-coupled V-V softmax; spatial mode ignores it
            with prof.phase("features_dispatch"):
                feats = feats_fn(images, valid)
            with prof.phase("step_dispatch"):
                loss = step_fn(text_adapter, feats, mask, class_idx, valid)
            text_step += 1
            return loss

        loader = make_train_loader(text_ds, args.text_batch_size,
                                   text_stage=True, seed=args.seed)
        loader.epoch = text_start_epoch
        for epoch in range(text_start_epoch, args.text_epoch):
            logger.info("training text epoch %d:", epoch)
            run_epoch(loader, 1, epoch, update_text)
            ckpt.save_adapter_checkpoint(
                text_ckpt, epoch + 1, text_adapter_to_jax(text_adapter),
                step=text_step, opt_state=text_state())
        del feats_fn, step_fn, loader

    # ---- anchors for stage 2 (reference train.py:338-344) ----------------
    enc = make_anchor_encoder(text, cfg, acfg,
                              text_adapter if args.text_epoch != 0 else None,
                              policy=policy)
    anchor_dict = encode_dataset_anchors(enc, args.dataset)
    anchors_table = torch.stack([anchor_dict[c] for c in class_names])
    del enc

    # ---- stage 2 ----------------------------------------------------------
    step_fn = make_stage2_step(vit, cfg, acfg, (image_opt, image_sched),
                               anchors_table, img_size=args.img_size,
                               policy=policy, remat=remat[2],
                               grad_accum=args.grad_accum, device=dev)

    def update_image(prof, images, mask, label, class_idx, valid):
        nonlocal image_step
        with prof.phase("step_dispatch"):
            loss = step_fn(image_adapter, images, mask, label, class_idx,
                           valid)
        image_step += 1
        return loss

    loader = make_train_loader(image_ds, args.image_batch_size,
                               text_stage=False, seed=args.seed + 1)
    loader.epoch = image_start_epoch
    fused = None
    if args.fused_assemble:  # parse_args required --cache_device
        # stage 2 only, as in the JAX CLI: stage 1's features and step
        # are two calls with the loss between them
        fused = loader.make_fused_step(step_fn)
        logger.info("fused_assemble: batch k+1 assembles %s",
                    "on a second CUDA stream while step k runs"
                    if dev.type == "cuda" else "after step k (no card)")
    elif args.cache_device:
        logger.info("cache_device: each batch assembles before its step "
                    "(not overlapped; --fused_assemble overlaps it)")
    for epoch in range(image_start_epoch, args.image_epoch):
        logger.info("training image epoch %d:", epoch)
        if fused is not None:
            run_fused_epoch(loader, fused)
        else:
            run_epoch(loader, 2, epoch, update_image)
        tree, state = adapter_to_jax(image_adapter), image_state()
        for path in (image_ckpt, os.path.join(
                args.save_path, f"image_adapter_{epoch + 1}.npz")):
            ckpt.save_adapter_checkpoint(path, epoch + 1, tree,
                                         step=image_step, opt_state=state)
    logger.info("done")

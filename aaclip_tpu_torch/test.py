"""Evaluation CLI: ``python -m aaclip_tpu_torch.test``.

The JAX package's ``test.py`` (reference test.py:102-250) on the card:
loads the frozen towers from an OpenAI-layout checkpoint (or the seeded
init), the text adapter and every image-adapter snapshot under
``--save_path`` (the npz format or the reference's ``.pth``), encodes the
text anchors, runs the per-class batched predict, and logs to
``{save_path}/test.log`` and prints the per-class table of pixel and image
AUROC and AP (and AUPRO under ``--aupro``) with its "Average" row, as a
plain fixed-width table; ``--csv`` and ``--dump_scores`` write
``results_<epoch>.csv`` and ``scores_<epoch>.csv`` with the JAX CLI's
headers. Needs neither PIL (for PNG datasets), pandas, scikit-learn nor
cv2. The metrics and the decode run on the host library
(``native/``) where it builds, else on their numpy paths; the log says
which, once, and each class's ``metrics_eval`` seconds.

``--memory_bank`` (with ``--shot``, ``--bank_weight``, ``--bank_chunk``)
fuses each class's few-shot memory bank into the prediction
(``eval/memory_bank.py``). The flags are the JAX CLI's; those of paths not
ported yet raise at parse time naming their ROADMAP item. ``main(argv, device="cpu")`` runs on the
CPU (the tests); by default it runs on the card.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import os
import re
import time

# flags of paths the port does not have yet -> (ROADMAP item, its title)
_A12 = ("A12", "int8, mesh and export")
_A15 = ("A15", "visualization")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Testing")
    # model (reference test.py:105-112)
    parser.add_argument("--model_name", type=str, default="ViT-L-14-336")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--relu", action="store_true")
    # testing (reference test.py:114-116)
    parser.add_argument("--dataset", type=str, default="MVTec")
    parser.add_argument("--shot", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=32)
    # exp (reference test.py:118-125)
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--save_path", type=str, default="ckpt/baseline")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--text_norm_weight", type=float, default=0.1)
    parser.add_argument("--text_adapt_weight", type=float, default=0.1)
    parser.add_argument("--image_adapt_weight", type=float, default=0.1)
    parser.add_argument("--text_adapt_until", type=int, default=3)
    parser.add_argument("--image_adapt_until", type=int, default=6)
    # the JAX package's extras
    parser.add_argument("--levels", type=int, nargs="+",
                        default=[6, 12, 18, 24])
    parser.add_argument("--precision", type=str, default="fp32",
                        choices=["fp32", "fp32_high", "bf16", "int8"],
                        help="fp32 = true fp32 products (TF32 off); "
                             "fp32_high = 3-pass products (three bf16 "
                             "passes) with the first --bf16_until blocks "
                             "at bf16; bf16 = the fast path (uint8 "
                             "inputs); int8 is not ported yet")
    parser.add_argument("--clip_checkpoint", type=str, default=None,
                        help="OpenAI-layout CLIP checkpoint (TorchScript "
                             "archive or state dict); default: AACLIP_CKPT "
                             "or aaclip_tpu_torch/weights/ViT-L-14-336px.pt "
                             "when its architecture matches, else the "
                             "seeded init")
    parser.add_argument("--bf16_until", type=int, default=None,
                        help="override the staged trunk depth (leading "
                             "vision blocks at single-pass bf16 products; "
                             "fp32 residual stream; inference only). "
                             "Default: the precision's own (6 for "
                             "fp32_high, 0 otherwise)")
    parser.add_argument("--int8_until", type=int, default=None)
    parser.add_argument("--aupro", action="store_true",
                        help="also compute pixel AUPRO")
    parser.add_argument("--csv", action="store_true",
                        help="also write results_<epoch>.csv under "
                             "save_path")
    parser.add_argument("--dump_scores", action="store_true",
                        help="also write per-image scores to "
                             "scores_<epoch>.csv under save_path (class, "
                             "file, label, image_score)")
    parser.add_argument("--fused_preprocess", action="store_true",
                        help="ship uint8 pixels; normalise on the card "
                             "inside the patch embedding (default with "
                             "bf16)")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--data_parallel", action="store_true")
    parser.add_argument("--tensor_parallel", type=int, default=1)
    parser.add_argument("--sequence_parallel", action="store_true")
    parser.add_argument("--pipeline_parallel", type=int, default=1)
    parser.add_argument("--pp_microbatches", type=int, default=None)
    parser.add_argument("--memory_bank", action="store_true",
                        help="few-shot mode: a per-class bank of adapted "
                             "patch features from the first --shot normal "
                             "training images, its nearest-neighbour scores "
                             "fused with the text-anchor prediction at "
                             "--bank_weight (eval/memory_bank.py)")
    parser.add_argument("--bank_weight", type=float, default=0.5,
                        help="fusion weight of the bank scores (0 = text "
                             "anchors alone, 1 = the bank alone)")
    parser.add_argument("--bank_chunk", type=int, default=1024,
                        help="bank rows per step of the max-similarity "
                             "loop (peak memory ~ [levels, B, L, chunk])")
    parser.add_argument("--artifact", type=str, default=None)
    args = parser.parse_args(argv)
    unported = [
        ("--precision int8", args.precision == "int8", _A12),
        ("--int8_until", args.int8_until is not None, _A12),
        ("--data_parallel", args.data_parallel, _A12),
        ("--tensor_parallel", args.tensor_parallel > 1, _A12),
        ("--sequence_parallel", args.sequence_parallel, _A12),
        ("--pipeline_parallel", args.pipeline_parallel > 1, _A12),
        ("--artifact", args.artifact is not None, _A12),
        ("--visualize", args.visualize, _A15),
    ]
    for flag, given, (item, title) in unported:
        if given:
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP {item}, '{title}'")
    if args.memory_bank and args.shot < 1:
        parser.error("--memory_bank needs --shot >= 1 support images")
    return args


def _snap_epoch(path: str) -> int:
    """The epoch of an ``image_adapter_{epoch}.{ext}`` snapshot: parsed,
    since lexicographic order puts 10 before 2."""
    m = re.search(r"image_adapter_(\d+)\.\w+$", path)
    return int(m.group(1)) if m else -1


def format_table(columns, rows) -> str:
    """Fixed-width text table: headers centred, numbers to 3 decimals."""
    cells = [[c if isinstance(c, str) else f"{c:.3f}" for c in r]
             for r in rows]
    widths = [max([len(h)] + [len(r[i]) for r in cells])
              for i, h in enumerate(columns)]
    lines = ["  ".join(h.center(w) for h, w in zip(columns, widths))]
    lines += ["  ".join(c.rjust(w) for c, w in zip(r, widths))
              for r in cells]
    return "\n".join(lines)


def _write_csv(path: str, header, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def main(argv=None, *, device=None):
    args = parse_args(argv)

    from aaclip_tpu_torch import native
    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_from_jax,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.datasets import BatchLoader, get_test_datasets
    from aaclip_tpu_torch.data.registry import DOMAINS
    from aaclip_tpu_torch.data.transforms import DECODE_COUNTS
    from aaclip_tpu_torch.device import resolve_device
    from aaclip_tpu_torch.eval.metrics import metrics_eval
    from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                               make_predict_fn,
                                               run_class_predictions)
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors
    from aaclip_tpu_torch.train import checkpoint as ckpt
    from aaclip_tpu_torch.utils.logging import setup_logger
    from aaclip_tpu_torch.utils.profiling import StepTimer
    from aaclip_tpu_torch.utils.seed import setup_seed

    dev = resolve_device(device)
    decoded_before = dict(DECODE_COUNTS)
    setup_seed(args.seed)
    os.makedirs(args.save_path, exist_ok=True)
    logger = setup_logger("aaclip.test",
                          os.path.join(args.save_path, "test.log"))
    logger.info("args: %s", vars(args))

    policy = DtypePolicy.from_name(args.precision)
    if args.bf16_until is not None:
        policy = dataclasses.replace(policy, bf16_until=args.bf16_until)
    cfg = get_config(args.model_name, args.img_size)
    acfg = AdapterConfig(
        text_adapt_weight=args.text_adapt_weight,
        image_adapt_weight=args.image_adapt_weight,
        text_adapt_until=args.text_adapt_until,
        image_adapt_until=args.image_adapt_until,
        levels=tuple(args.levels),
        proj_relu=args.relu,
    )
    vit, text = create_clip_towers(cfg, checkpoint=args.clip_checkpoint,
                                   seed=args.seed, device=dev)
    # the checkpoint trees' expected structure and shapes
    image_template = adapter_to_jax(
        init_image_adapter(cfg, acfg, seed=args.seed, device="cpu"))
    text_template = text_adapter_to_jax(
        init_text_adapter(cfg, acfg, seed=args.seed, device="cpu"))

    # ---- text adapter (reference test.py:163-170) -------------------------
    text_adapter = None
    npz = ckpt.find_adapter_checkpoint(
        os.path.join(args.save_path, "text_adapter.npz"))
    pths = glob.glob(os.path.join(args.save_path, "text_adapter.pth"))
    tree = None
    if npz:
        _, tree, _ = ckpt.load_adapter_checkpoint_any(npz, text_template)
    elif pths:
        _, tree = ckpt.load_reference_checkpoint(
            pths[0], "text", n_adapt=args.text_adapt_until)
    if tree is not None:
        text_adapter = text_adapter_from_jax(tree, cfg, acfg, device=dev)

    # ---- image adapter snapshots (reference test.py:172-177) -------------
    files = []
    for ext in ("npz", "orbax", "pth"):
        files += sorted(glob.glob(os.path.join(
            args.save_path, f"image_adapter_*.{ext}")), key=_snap_epoch)
    if not files:  # not an assert: python -O would skip it
        raise SystemExit(
            f"image adapter checkpoint not found under {args.save_path!r}")

    uint8_inputs = args.fused_preprocess or args.precision == "bf16"
    predict_fn = make_predict_fn(vit, cfg, acfg, policy=policy,
                                 uint8_inputs=uint8_inputs, device=dev)
    mb_predict = support = None
    if args.memory_bank:
        from aaclip_tpu_torch.eval import memory_bank as mb

        mb_predict = mb.make_mb_predict_fn(
            vit, cfg, acfg, policy=policy, uint8_inputs=uint8_inputs,
            bank_weight=args.bank_weight, chunk=args.bank_chunk, device=dev)
        # classes absent from the metadata are skipped (their test splits
        # are empty too)
        support = mb.collect_support_sets(args.dataset, args.shot,
                                          args.img_size, uint8=uint8_inputs,
                                          log=logger)
        logger.info("memory_bank: fusing %d-shot nearest-neighbor scores "
                    "at weight %.2f", args.shot, args.bank_weight)
    domain = DOMAINS[args.dataset]
    # the datasets and anchors do not change across snapshots
    image_datasets = get_test_datasets(args.dataset, args.img_size,
                                       uint8=uint8_inputs)
    enc = make_anchor_encoder(text, cfg, acfg, text_adapter, policy=policy)
    text_embeddings = encode_dataset_anchors(enc, args.dataset)
    grid = cfg.vision.grid

    def eval_one(image_adapter, label) -> None:
        """One results table (the reference's per-snapshot block,
        test.py:179-250)."""
        logger.info("-----------------------------------------------")
        logger.info("load model from epoch %s", label)
        logger.info("-----------------------------------------------")
        columns = ["class name", "pixel AUC", "pixel AP", "image AUC",
                   "image AP"]
        if args.aupro:
            columns.append("pixel AUPRO")
        rows, score_rows = [], []
        timer = StepTimer()
        for class_name, dataset in image_datasets.items():
            # per-class size (reference dataset/__init__.py:145-148)
            logger.info("Class name: %s", class_name)
            logger.info("Sample number: %d", len(dataset))
            logger.info("=====================================")
            if len(dataset) == 0:
                logger.info("skipping empty class %s", class_name)
                continue
            loader = BatchLoader(dataset, args.batch_size,
                                 num_workers=args.num_workers)
            fn = predict_fn
            if mb_predict is not None:
                if class_name not in support:
                    # a bank-less class would mix protocols in one table
                    raise SystemExit(
                        f"--memory_bank: class {class_name!r} has test "
                        "images but no training metadata to draw support "
                        "from")
                # per snapshot and class: the bank comes from the adapters
                # under evaluation (reference test.py:41)
                bank = mb.collect_bank(mb_predict.features_fn, image_adapter,
                                       support[class_name],
                                       batch_size=args.batch_size)
                logger.info("memory bank: %d patch vectors/level x %d "
                            "levels (%d-shot)", bank.shape[1], bank.shape[0],
                            args.shot)

                def fn(ia, im, an, M, _bank=bank):
                    return mb_predict(ia, im, an, M, _bank)
                fn.device = mb_predict.device
            masks, labels, preds, preds_image, file_names = \
                run_class_predictions(fn, image_adapter, loader,
                                      text_embeddings[class_name], domain,
                                      args.img_size, grid)
            timer.tick(len(file_names))
            score_rows += [(class_name, f, int(lab), float(sc)) for f, lab, sc
                           in zip(file_names, labels, preds_image)]
            t0 = time.perf_counter()
            row = metrics_eval(masks, labels, preds, preds_image, class_name,
                               domain, compute_aupro=args.aupro)
            logger.info("metrics_eval: %.3f s", time.perf_counter() - t0)
            rows.append([row[c] if c == "class name" else float(row[c])
                         for c in columns])
        if timer.rate():
            # the first class's window holds the warm-up
            logger.info("eval throughput: %.2f maps/s", timer.rate())
        n = len(rows)
        rows.append(["Average"] + [
            sum(r[i] for r in rows) / n if n else float("nan")
            for i in range(1, len(columns))])
        table = format_table(columns, rows)
        logger.info("final results:\n%s", table)
        print(table)
        if args.csv:
            path = os.path.join(args.save_path, f"results_{label}.csv")
            _write_csv(path, columns, rows)
            logger.info("wrote %s", path)
        if args.dump_scores:
            path = os.path.join(args.save_path, f"scores_{label}.csv")
            _write_csv(path, ["class name", "file", "label", "image_score"],
                       score_rows)
            logger.info("wrote %s", path)

    for file in files:
        if file.endswith(".pth"):
            test_epoch, tree = ckpt.load_reference_checkpoint(
                file, "image", n_adapt=args.image_adapt_until,
                n_levels=len(args.levels))
        else:
            test_epoch, tree, _ = ckpt.load_adapter_checkpoint_any(
                file, image_template)
        eval_one(adapter_from_jax(tree, cfg, acfg, device=dev), test_epoch)
    # which host paths produced the numbers: the native library or numpy
    info = native.build_info()
    logger.info("host paths: metrics %s (%s); decode native %d, fallback "
                "%d images and masks (image library: %s)",
                native.metrics_path(), info.get("fast_metrics"),
                *(DECODE_COUNTS[k] - decoded_before[k]
                  for k in ("native", "fallback")), info.get("fast_image"))


if __name__ == "__main__":
    main()

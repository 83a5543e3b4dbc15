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
(``eval/memory_bank.py``). ``--precision int8`` (with ``--int8_until K``)
quantizes the trunk (``ops/quant.py``). ``--artifact DIR`` evaluates an
exported artifact (``deploy.py``) instead of building the model: the
programs, weights and anchors that ``serve --artifact`` would run, with
its bundled banks under ``--memory_bank``. ``--visualize`` writes each
image's panel (the image, the mask's and the map's JET overlays) under
``{save_path}/visualization/`` (``eval/visualize.py``). The flags are the
JAX CLI's. ``main(argv, device="cpu")`` runs on the CPU (the tests); by
default it runs on the card.

``--data_parallel`` and ``--tensor_parallel N`` (with
``--sequence_parallel``) run one process per card under ``torchrun``
(``python -m torch.distributed.run --nproc_per_node K -m
aaclip_tpu_torch.test ...``; ``parallel/``): ``--batch_size`` is the
global batch, rounded up to a multiple of the data size; each data rank
reads, decodes and predicts only its rows of each global batch (its
loader's ``deal_batches``: rows r, r + dp, ...; the ranks of one model
group share rows), and each class's maps, masks, labels and scores are
gathered for the metrics; rank 0 alone writes the log, the table and
the CSVs. ``--pipeline_parallel N`` (with ``--pp_microbatches``) GPipes
the trunk over N processes (``parallel/pipeline.py``), replicated over
``world // N`` data replicas under ``--data_parallel``: every rank reads
the global batch, as JAX's pipeline takes it replicated, rounded up to a
multiple of microbatches x replicas, and the staged trunk and the uint8
inputs are off. The parallel flags' rules are JAX's.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import os
import re
import time

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
                             "inputs); int8 = the trunk's big products "
                             "int8 x int8 -> int32 (inference only)")
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
    parser.add_argument("--int8_until", type=int, default=None,
                        help="with --precision int8: quantize only the "
                             "first K vision blocks, the rest bf16 "
                             "(default 0 = the whole trunk)")
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
    parser.add_argument("--pipeline_parallel", type=int, default=1,
                        help="GPipe the trunk over this many processes "
                             "(stage boundaries on the tap levels, so it "
                             "must divide the level count; each holds "
                             "layers/N blocks). Composes with "
                             "--data_parallel (the remaining processes form "
                             "the data axis); excludes --tensor_parallel; "
                             "disables the staged trunk and the fused uint8 "
                             "preprocessing")
    parser.add_argument("--pp_microbatches", type=int, default=None,
                        help="microbatch count for --pipeline_parallel "
                             "(default = stage count; the batch is rounded "
                             "up to a multiple of it)")
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
    parser.add_argument("--artifact", type=str, default=None,
                        help="evaluate an exported artifact directory "
                             "(python -m aaclip_tpu_torch.deploy) instead "
                             "of building the model; the model, adapter "
                             "and precision flags are ignored, --dataset "
                             "must be bundled in it")
    args = parser.parse_args(argv)
    tp = args.tensor_parallel > 1
    pp = args.pipeline_parallel > 1
    if args.artifact and (args.data_parallel or tp
                          or args.sequence_parallel or pp):
        parser.error("--artifact serves frozen single-device graphs; "
                     "parallel flags need the live model path")
    if args.memory_bank and (tp or pp):
        parser.error("--memory_bank runs the live predictor (banks are "
                     "per-class, per-snapshot device arrays); it composes "
                     "with --data_parallel, and with --artifact when the "
                     "artifact bundles banks (export --memory_bank_shot)")
    if args.sequence_parallel and not tp:
        parser.error("--sequence_parallel requires --tensor_parallel N > 1")
    if args.precision == "int8" and tp:
        parser.error("int8 quantized inference does not compose with "
                     "tensor parallelism")
    if args.memory_bank and args.shot < 1 and not args.artifact:
        parser.error("--memory_bank needs --shot >= 1 support images "
                     "(artifact banks carry their own shot count)")
    if args.int8_until is not None and args.precision != "int8":
        parser.error("--int8_until requires --precision int8")
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

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_from_jax,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.datasets import get_test_datasets
    from aaclip_tpu_torch.data.registry import DOMAINS
    from aaclip_tpu_torch.data.transforms import DECODE_COUNTS
    from aaclip_tpu_torch.device import resolve_device
    from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                               make_predict_fn)
    from aaclip_tpu_torch.parallel.sharding import cli_mesh
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors
    from aaclip_tpu_torch.train import checkpoint as ckpt
    from aaclip_tpu_torch.utils.logging import setup_logger
    from aaclip_tpu_torch.utils.seed import setup_seed

    pp_mesh = mesh = None
    if args.pipeline_parallel > 1:
        from aaclip_tpu_torch.parallel.pipeline import cli_pp_mesh

        pp_mesh = cli_pp_mesh(args.pipeline_parallel, args.data_parallel,
                              args.tensor_parallel, args.sequence_parallel,
                              device)
        dev, lead = pp_mesh.device, pp_mesh.is_lead
    else:
        mesh = cli_mesh(args.data_parallel, args.tensor_parallel, device)
        dev = mesh.device if mesh is not None else resolve_device(device)
        lead = mesh is None or mesh.is_lead
    decoded_before = dict(DECODE_COUNTS)
    setup_seed(args.seed)
    os.makedirs(args.save_path, exist_ok=True)
    logger = setup_logger("aaclip.test",
                          os.path.join(args.save_path, "test.log"),
                          enabled=lead)
    logger.info("args: %s", vars(args))
    if mesh is not None:
        logger.info("mesh: data=%d x model=%d", mesh.dp, mesh.tp)
        if args.batch_size % mesh.dp:
            args.batch_size = -(-args.batch_size // mesh.dp) * mesh.dp
            logger.info("data_parallel: batch_size rounded up to %d "
                        "(%d-way data axis)", args.batch_size, mesh.dp)

    if args.artifact:
        return _eval_artifact(args, logger, dev, decoded_before)
    policy = DtypePolicy.from_name(args.precision)
    if args.bf16_until is not None:
        policy = dataclasses.replace(policy, bf16_until=args.bf16_until)
    uint8_inputs = args.fused_preprocess or args.precision in ("bf16",
                                                               "int8")
    if pp_mesh is not None:
        if policy.bf16_until:
            policy = dataclasses.replace(policy, bf16_until=0)
            logger.info("pipeline_parallel: staged-precision trunk disabled")
        uint8_inputs = False  # the pipeline embeds normalised float pixels
        n_micro = args.pp_microbatches or args.pipeline_parallel
        chunk = n_micro * pp_mesh.dp
        if args.batch_size % chunk:
            args.batch_size = -(-args.batch_size // chunk) * chunk
            logger.info("pipeline_parallel: batch_size rounded up to %d "
                        "(%d microbatches x dp=%d)", args.batch_size,
                        n_micro, pp_mesh.dp)
        logger.info("mesh: stage=%d x data=%d (GPipe, %d microbatches)",
                    pp_mesh.pp, pp_mesh.dp, n_micro)
        if not pp_mesh.active:
            logger.info("rank %d is outside the stage x data mesh: idle",
                        pp_mesh.rank)
            return
    if args.int8_until is not None:
        policy = dataclasses.replace(policy, int8_until=args.int8_until)
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

    if pp_mesh is not None:
        from aaclip_tpu_torch.parallel.pipeline import \
            make_pipeline_predict_fn

        predict_fn = make_pipeline_predict_fn(
            vit, cfg, acfg, pp=pp_mesh.pp, n_micro=args.pp_microbatches,
            dp=pp_mesh.dp, policy=policy, mesh=pp_mesh)
    else:
        predict_fn = make_predict_fn(
            vit, cfg, acfg, policy=policy, uint8_inputs=uint8_inputs,
            mesh=mesh, sequence_parallel=args.sequence_parallel,
            device=None if mesh else dev)
    mb_predict = support = None
    if args.memory_bank:
        from aaclip_tpu_torch.eval import memory_bank as mb

        mb_predict = mb.make_mb_predict_fn(
            vit, cfg, acfg, policy=policy, uint8_inputs=uint8_inputs,
            bank_weight=args.bank_weight, chunk=args.bank_chunk, mesh=mesh,
            device=None if mesh else dev)
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

    def class_fn(class_name, image_adapter):
        if mb_predict is None:
            return predict_fn
        if class_name not in support:
            # a bank-less class would mix protocols in one table
            raise SystemExit(
                f"--memory_bank: class {class_name!r} has test images but "
                "no training metadata to draw support from")
        # per snapshot and class: the bank comes from the adapters under
        # evaluation (reference test.py:41)
        bank = mb.collect_bank(mb_predict.features_fn, image_adapter,
                               support[class_name],
                               batch_size=args.batch_size)
        logger.info("memory bank: %d patch vectors/level x %d levels "
                    "(%d-shot)", bank.shape[1], bank.shape[0], args.shot)

        def fn(ia, im, an, M):
            return mb_predict(ia, im, an, M, bank)

        def local(ia, im, an, M):
            return mb_predict.local(ia, im, an, M, bank)

        fn.device, fn.mesh, fn.local = mb_predict.device, mb_predict.mesh, \
            local
        return fn

    for file in files:
        if file.endswith(".pth"):
            test_epoch, tree = ckpt.load_reference_checkpoint(
                file, "image", n_adapt=args.image_adapt_until,
                n_levels=len(args.levels))
        else:
            test_epoch, tree, _ = ckpt.load_adapter_checkpoint_any(
                file, image_template)
        _eval_table(args, logger, test_epoch, image_datasets, class_fn,
                    adapter_from_jax(tree, cfg, acfg, device=dev),
                    text_embeddings, domain, grid, lead, mesh)
    _log_host_paths(logger, decoded_before)



def _log_host_paths(logger, decoded_before: dict) -> None:
    """Which host paths produced the numbers: the native library or
    numpy."""
    from aaclip_tpu_torch import native
    from aaclip_tpu_torch.data.transforms import DECODE_COUNTS

    info = native.build_info()
    logger.info("host paths: metrics %s (%s); decode native %d, fallback "
                "%d images and masks (image library: %s)",
                native.metrics_path(), info.get("fast_metrics"),
                *(DECODE_COUNTS[k] - decoded_before[k]
                  for k in ("native", "fallback")), info.get("fast_image"))


def _eval_table(args, logger, label, image_datasets, class_fn,
                image_adapter, text_embeddings, domain: str,
                grid: int, lead: bool = True, mesh=None) -> None:
    """One results table (the reference's per-snapshot block,
    test.py:179-250): each class's loader through ``class_fn(class_name,
    image_adapter)``'s predictor (``run_class_predictions``), its metrics,
    the table with its "Average" row, and the CSVs the flags ask for. A
    rank other than the lead (``lead`` False) predicts with the others and
    writes nothing. On a ``mesh`` each data rank's loader reads its rows
    of each global batch of a class."""
    from aaclip_tpu_torch.data.datasets import BatchLoader
    from aaclip_tpu_torch.eval.metrics import metrics_eval
    from aaclip_tpu_torch.eval.predict import run_class_predictions
    from aaclip_tpu_torch.utils.profiling import StepTimer

    deal = {} if mesh is None else dict(
        host_id=mesh.data_rank, num_hosts=mesh.dp, deal_batches=True)

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
                             num_workers=args.num_workers, **deal)
        masks, labels, preds, preds_image, file_names = \
            run_class_predictions(class_fn(class_name, image_adapter),
                                  image_adapter, loader,
                                  text_embeddings[class_name], domain,
                                  args.img_size, grid)
        timer.tick(len(file_names))
        if not lead:
            continue
        if args.visualize:
            from aaclip_tpu_torch.eval.visualize import visualize

            visualize(masks, preds, file_names, args.save_path,
                      args.dataset, class_name)
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
    if not lead:
        return
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


def _eval_artifact(args, logger, device, decoded_before: dict) -> None:
    """``--artifact``: the table of an exported artifact (``deploy.py``),
    the programs, weights and anchors that ``serve --artifact`` runs; with
    ``--memory_bank`` its bundled banks. The image size and grid come from
    the artifact; its programs take uint8 inputs."""
    import torch

    from aaclip_tpu_torch.data.datasets import get_test_datasets
    from aaclip_tpu_torch.data.registry import DOMAINS
    from aaclip_tpu_torch.deploy import load_serving_artifact

    art = load_serving_artifact(args.artifact, device=device)
    if args.dataset not in art.anchors:
        raise SystemExit(f"dataset {args.dataset!r} not in artifact "
                         f"({sorted(art.anchors)}): re-export with "
                         "--datasets")
    m = art.manifest
    if art.untrained:
        logger.warning("artifact %s carries RANDOM-INIT adapters "
                       "(manifest.untrained=true): the metrics are not "
                       "anomaly detection results", args.artifact)
    args.img_size = art.img_size  # the loader must feed the programs' shape
    logger.info("artifact manifest: model %s @ %dpx, precision %s, "
                "adapters %s", m["model_name"], art.img_size,
                m["precision"], m["image_adapter_ckpt"] or "random-init")
    M = art._postproc_dev[args.dataset]
    banks = {}
    if args.memory_bank:
        banks = art.banks.get(args.dataset, {})
        if not banks:
            raise SystemExit(
                "--memory_bank with --artifact needs banks bundled at "
                "export (python -m aaclip_tpu_torch.deploy "
                "--memory_bank_shot K); this artifact has none for "
                f"{args.dataset!r}")
        logger.info("artifact memory bank: %d-shot, weight %.2f, %d classes "
                    "banked", art.shot, art.bank_weight, len(banks))
        # the shot count and the weight are baked into the exported banks
        # and programs: a differing flag would be ignored silently
        if abs(args.bank_weight - art.bank_weight) > 1e-9:
            logger.warning("--bank_weight %.2f has no effect on an artifact "
                           "(weight %.2f was baked at export)",
                           args.bank_weight, art.bank_weight)
        if args.shot not in (4, art.shot):  # 4: the default
            logger.warning("--shot %d has no effect on an artifact (banks "
                           "were built %d-shot at export)", args.shot,
                           art.shot)

    def class_fn(class_name, _adapter):
        bank = None
        if args.memory_bank:
            if class_name not in banks:
                raise SystemExit(f"--memory_bank: class {class_name!r} has "
                                 "test images but no bank in the artifact: "
                                 "re-export")
            bank = art.class_bank(args.dataset, class_name)

        def fn(_a, images, anchors, _M):
            # the artifact's own M; anchors per sample, as its programs
            # take them
            anchors = anchors.expand(images.shape[0], -1, -1)
            with torch.inference_mode():
                return art.predict_tensors(images, anchors, M, bank)
        fn.device = art.device
        return fn

    _eval_table(args, logger, "artifact",
                get_test_datasets(args.dataset, args.img_size, uint8=True),
                class_fn, None, {k: torch.from_numpy(v) for k, v in
                                 art.anchors[args.dataset].items()},
                DOMAINS[args.dataset], int(m["grid"]))
    _log_host_paths(logger, decoded_before)


if __name__ == "__main__":
    main()

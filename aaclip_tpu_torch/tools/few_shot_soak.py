"""Few-shot soak: K-shot two-stage training + evaluation per K.

The reference's few-shot protocol is ``--training_mode few_shot --shot K``
over K records per class sampled from the metadata. This tool drives that
path end to end on the port, at production shapes (ViT-L-14-336 @ 518) by
default, as the JAX package's ``tools/few_shot_soak.py`` drives JAX's:

it generates a synthetic dataset (``data/synthetic.py``, 12 images per
class), derives K-shot metadata with ``tools/make_few_shot.py``
(``--include_anomalous`` so the tiny support sets carry localization
signal for a random backbone), then for each K runs the port's training
CLI (both stages, few_shot mode, ``--device_augment`` unless
--host_augment) and its evaluation CLI with ``--aupro`` (and, with
--memory_bank, once more with ``--memory_bank`` in a save dir of its own,
the banks built from the normal images of the same K-shot files) and
prints one summary line per K and ``FEW-SHOT SOAK OK``. A bank needs a
normal image of every class: on this set the 1-shot draw holds none of
``bottle``, so ``--memory_bank`` takes shots such as 2 and 4.

One departure from JAX's tool: under ``--memory_bank`` the port reads
every K-shot file right after drawing them and exits, before any
training, naming the first shot and class whose draw holds no normal
(label 0) record. JAX's tool finds it only when that shot's banked
evaluation raises (``eval/memory_bank.py``'s "no normal (label 0)
records"), after the shot's whole training run. The draws are JAX's, so
at every shot JAX's tool completes the port's tables are JAX's.

    python -u -m aaclip_tpu_torch.tools.few_shot_soak --shots 1 2 4 \
        --precision bf16 --workdir /tmp/fewshot_soak
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import tempfile
import time


def last_average_row(log_path: str):
    """(pixel AUC, pixel AP, image AUC, image AP[, AUPRO]) of the final
    snapshot's Average row in an evaluation-CLI log."""
    rows = [l for l in open(log_path) if re.search(r"^\s*Average\s", l)]
    if not rows:
        return None
    return [float(x) for x in rows[-1].split()[1:]]


def classes_without_normals(dataset: str, shot: int) -> list:
    """The classes of the ``{shot}-shot`` training metadata that hold no
    normal (label 0) record: the classes whose memory bank
    (``eval/memory_bank.py::support_records``) cannot be built."""
    from aaclip_tpu_torch.data.datasets import metadata_path, read_jsonl
    from aaclip_tpu_torch.data.registry import CLASS_NAMES

    records = read_jsonl(metadata_path(dataset, shot))
    present = {r.class_name for r in records}
    normal = {r.class_name for r in records if r.label == 0}
    return [c for c in CLASS_NAMES[dataset] if c in present - normal]


def main(argv=None, *, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=None)
    p.add_argument("--shots", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--model_name", default="ViT-L-14-336")
    p.add_argument("--img_size", type=int, default=518)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--text_epoch", type=int, default=2)
    p.add_argument("--image_epoch", type=int, default=2)
    p.add_argument("--text_batch_size", type=int, default=16)
    p.add_argument("--image_batch_size", type=int, default=8)
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--host_augment", action="store_true",
                   help="use the host augmentation path instead of "
                        "--device_augment (the soak default is all "
                        "card-side features on)")
    p.add_argument("--memory_bank", action="store_true",
                   help="additionally eval each K with --memory_bank (the "
                        "paper's few-shot protocol: per-class support "
                        "banks fused at --bank_weight) and report both "
                        "tables")
    p.add_argument("--bank_weight", type=float, default=0.5)
    # small-model passthroughs (CPU smoke: --model_name tiny-test
    # --img_size 70 --levels 1 2 --surgery_until_layer 2
    # --text_adapt_until 1 --image_adapt_until 1)
    p.add_argument("--levels", type=int, nargs="+", default=None)
    p.add_argument("--surgery_until_layer", type=int, default=None)
    p.add_argument("--text_adapt_until", type=int, default=None)
    p.add_argument("--image_adapt_until", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=4)
    args = p.parse_args(argv)

    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset

    if max(args.shots) > 12:
        raise SystemExit(
            f"--shots {args.shots}: the synthetic dataset has 12 images "
            f"per class, so K > 12 would silently truncate to the same "
            f"12-image support set while reporting a larger shot count")
    root = args.workdir or tempfile.mkdtemp(prefix="aaclip_fewshot_")
    data_root, meta_root = make_synthetic_dataset(
        root, img_px=args.img_size, n_normal=6, n_anomalous=6)
    os.environ["AACLIP_DATA"] = data_root
    os.environ["AACLIP_METADATA"] = meta_root
    print(f"synthetic dataset under {root}", flush=True)

    from aaclip_tpu_torch import test as test_cli
    from aaclip_tpu_torch.tools.make_few_shot import main as make_few_shot
    from aaclip_tpu_torch.train import cli as train_cli

    make_few_shot(["--dataset", "MVTec", "--seed", "111",
                   "--include_anomalous",
                   "--shots"] + [str(k) for k in args.shots])
    if args.memory_bank:
        for k in args.shots:
            missing = classes_without_normals("MVTec", k)
            if missing:
                raise SystemExit(
                    f"--memory_bank: the {k}-shot draw holds no normal "
                    f"(label 0) record of class {missing[0]!r}, so its "
                    f"memory bank cannot be built; take shots whose draws "
                    f"hold a normal image of every class (2 and 4 here). "
                    f"Nothing was trained.")

    common = [
        "--model_name", args.model_name, "--img_size", str(args.img_size),
        "--dataset", "MVTec", "--precision", args.precision,
    ]
    if args.levels is not None:
        common += ["--levels"] + [str(v) for v in args.levels]
    if args.text_adapt_until is not None:
        common += ["--text_adapt_until", str(args.text_adapt_until)]
    if args.image_adapt_until is not None:
        common += ["--image_adapt_until", str(args.image_adapt_until)]
    common += ["--num_workers", str(args.num_workers)]
    train_only = []  # flags the training CLI has but the evaluation lacks
    if args.surgery_until_layer is not None:
        train_only += ["--surgery_until_layer", str(args.surgery_until_layer)]
    summary = []
    for k in args.shots:
        save = os.path.join(root, f"ckpt_{k}shot")
        t0 = time.time()
        train_cli.main(common + train_only + [
            "--save_path", save, "--training_mode", "few_shot",
            "--shot", str(k),
            "--text_epoch", str(args.text_epoch),
            "--image_epoch", str(args.image_epoch),
            "--text_batch_size", str(args.text_batch_size),
            "--image_batch_size", str(args.image_batch_size),
        ] + ([] if args.host_augment else ["--device_augment"]),
            device=device)
        t1 = time.time()
        test_cli.main(common + [
            "--save_path", save, "--shot", str(k),
            "--batch_size", str(args.eval_batch_size), "--aupro",
        ], device=device)
        t2 = time.time()
        row = last_average_row(os.path.join(save, "test.log"))
        if row is None:
            raise RuntimeError(
                f"{k}-shot: no 'Average' row in {save}/test.log — the eval "
                "did not produce a metric table; see the log above")
        line = (f"{k}-shot: train {t1 - t0:.0f}s eval {t2 - t1:.0f}s "
                f"pixel_auroc {row[0]:.2f} pixel_ap {row[1]:.2f} "
                f"image_auroc {row[2]:.2f} image_ap {row[3]:.2f} "
                f"aupro {row[4]:.2f}")
        print(line, flush=True)
        summary.append(line)
        if args.memory_bank:
            # a save dir of its own: the evaluation CLI appends every run
            # to test.log, and last_average_row must not read the
            # text-only table
            save_mb = os.path.join(root, f"ckpt_{k}shot_mb")
            os.makedirs(save_mb, exist_ok=True)
            for f in glob.glob(os.path.join(save, "*.npz")):
                shutil.copy(f, save_mb)  # image AND text adapters
            t3 = time.time()
            test_cli.main(common + [
                "--save_path", save_mb, "--shot", str(k),
                "--batch_size", str(args.eval_batch_size), "--aupro",
                "--memory_bank", "--bank_weight", str(args.bank_weight),
            ], device=device)
            t4 = time.time()
            row = last_average_row(os.path.join(save_mb, "test.log"))
            if row is None:
                raise RuntimeError(f"{k}-shot mb: no 'Average' row in "
                                   f"{save_mb}/test.log")
            line = (f"{k}-shot +memory_bank(w={args.bank_weight}): "
                    f"eval {t4 - t3:.0f}s "
                    f"pixel_auroc {row[0]:.2f} pixel_ap {row[1]:.2f} "
                    f"image_auroc {row[2]:.2f} image_ap {row[3]:.2f} "
                    f"aupro {row[4]:.2f}")
            print(line, flush=True)
            summary.append(line)

    print("\n=== few-shot soak summary ===")
    for line in summary:
        print(line)
    print("FEW-SHOT SOAK OK")


if __name__ == "__main__":
    main()

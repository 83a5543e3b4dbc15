"""A/B on the card: evaluate ONE trained checkpoint at two precisions; diff
the task-metric tables and the per-image score ranking.

The JAX package's ``tools/precision_ab.py`` on the port's CLIs: one
two-stage training run (bf16, ``--device_augment``) on a synthetic set,
then ``python -m aaclip_tpu_torch.test --aupro --csv --dump_scores`` at
the baseline and the candidate precision (any of fp32, fp32_high, bf16,
int8, with ``--*_bf16_until`` / ``--*_int8_until``), each table stashed as
``ab__<tag>__results_<epoch>.csv`` (and ``__scores_``), and the verdict:

- one image-level rank flip on an n_pos x n_neg class eval moves AUROC by
  100/(n_pos*n_neg) points — derived from the ACTUAL --n_normal /
  --n_anomalous used to build the dataset;
- --hard makes the image task unsaturated by construction (variable-
  contrast defects + bright distractors on normals, ``data/synthetic.py``)
  so AUROC 100.0 can't mask rank flips;
- beyond the table diff, a Spearman rank correlation over every per-image
  anomaly score (numpy), pooled and per class.

The tables are read with the csv module and rounded as the reference
prints them (2 decimals); no pandas.

Usage:
  python -m aaclip_tpu_torch.tools.precision_ab          # bf16 vs int8
  python -m aaclip_tpu_torch.tools.precision_ab --baseline fp32 \
      --candidate fp32_high --candidate_bf16_until 12
Exit 0 = tables agree within the granularity-aware tolerances (or exactly,
--strict) AND Spearman rho >= --min_rho.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import re
import shutil
import tempfile
import time

PRECISIONS = ("fp32", "fp32_high", "bf16", "int8")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=None)
    p.add_argument("--model_name", default="ViT-L-14-336")
    p.add_argument("--img_size", type=int, default=518)
    p.add_argument("--baseline", default="bf16", choices=PRECISIONS)
    p.add_argument("--candidate", default="int8", choices=PRECISIONS)
    p.add_argument("--baseline_bf16_until", type=int, default=None,
                   help="staged-trunk depth for the baseline eval "
                        "(--bf16_until of the evaluation CLI)")
    p.add_argument("--baseline_int8_until", type=int, default=None,
                   help="mixed-prefix quantization depth for an int8 "
                        "baseline (--int8_until of the evaluation CLI)")
    p.add_argument("--candidate_int8_until", type=int, default=None,
                   help="mixed-prefix quantization depth for an int8 "
                        "candidate: quantize blocks [0,K), keep the "
                        "det-token tail bf16")
    p.add_argument("--candidate_bf16_until", type=int, default=None,
                   help="staged-trunk depth for the candidate eval")
    p.add_argument("--n_classes", type=int, default=2,
                   help="synthetic classes (MVTec class names)")
    p.add_argument("--n_normal", type=int, default=16,
                   help="normal test images per class")
    p.add_argument("--n_anomalous", type=int, default=16,
                   help="anomalous test images per class")
    p.add_argument("--hard", action="store_true",
                   help="unsaturated image task by construction (variable-"
                        "contrast defects, distractors on normals)")
    p.add_argument("--text_batch_size", type=int, default=16)
    p.add_argument("--image_batch_size", type=int, default=8)
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4)
    # tiny-config overrides (CPU smoke: --model_name tiny-test --img_size 70
    # --levels 1 2 --text_adapt_until 1 --image_adapt_until 1)
    p.add_argument("--levels", type=int, nargs="+", default=None)
    p.add_argument("--text_adapt_until", type=int, default=None)
    p.add_argument("--image_adapt_until", type=int, default=None)
    p.add_argument("--keep", action="store_true",
                   help="keep the workdir (default: temp dir, left behind "
                        "only if the A/B fails)")
    p.add_argument("--strict", action="store_true",
                   help="demand digit-identical tables instead of the "
                        "granularity-aware tolerances")
    p.add_argument("--pixel_tol", type=float, default=0.25,
                   help="max allowed |delta| in points for pixel-level "
                        "columns (AUC/AP/AUPRO over ~2.1M pixels per class)")
    p.add_argument("--image_flips", type=int, default=3,
                   help="max allowed image-level |delta| in units of one "
                        "rank flip = 100/(n_normal*n_anomalous) points per "
                        "class (recomputed from the actual dataset shape)")
    p.add_argument("--min_rho", type=float, default=0.99,
                   help="min Spearman rank correlation between the two "
                        "precisions' per-image scores (pooled, and worst "
                        "per class)")
    p.add_argument("--compare_only", default=None, metavar="CKPT_DIR",
                   help="skip train/eval; re-verdict the ab__<prec>__*.csv "
                        "pair already stashed in CKPT_DIR (a kept workdir's "
                        "ckpt_ab/). Requires exactly one stash per "
                        "precision; flip granularity then comes from "
                        "--n_normal/--n_anomalous, which must match the "
                        "run that produced the stash")
    return p.parse_args(argv)


def _snap_epoch(name):
    # results_<epoch>.csv with no zero padding: lexicographic order puts
    # 10 before 2
    m = re.search(r"_(\d+)\.csv$", name)
    return int(m.group(1)) if m else -1


def _tags(args):
    """Distinct stash tags for the two evals (bf16_until / int8_until
    make e.g. fp32_high-vs-fp32_high@12 or int8-vs-int8#18 legal pairs)."""
    def tag(prec, until, i8):
        t = prec if until is None else f"{prec}@{until}"
        return t if i8 is None else f"{t}#{i8}"
    return (tag(args.baseline, args.baseline_bf16_until,
                args.baseline_int8_until),
            tag(args.candidate, args.candidate_bf16_until,
                args.candidate_int8_until))


def read_table(path: str) -> dict:
    """A results CSV as ``{"columns": header, "rows": [[class, floats...]]}``
    with every number rounded to the reference's printed 2 decimals."""
    import numpy as np

    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    return {"columns": header,
            "rows": [[r[0]] + [float(np.round(float(x), 2)) for x in r[1:]]
                     for r in rows]}


def read_scores(path: str) -> list:
    """A per-image scores CSV as ``[(class, file, image_score)]``."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [(r["class name"], r["file"], float(r["image_score"]))
            for r in rows]


def main(argv=None, *, device=None):
    args = parse_args(argv)
    if (args.baseline, args.baseline_bf16_until,
            args.baseline_int8_until) == \
            (args.candidate, args.candidate_bf16_until,
             args.candidate_int8_until):
        raise SystemExit("baseline and candidate are the same configuration")
    # validate the int8_until/precision pairing now: the evaluation CLI
    # would reject it too, but only after the training phase already ran
    for side, prec, i8 in (("baseline", args.baseline,
                            args.baseline_int8_until),
                           ("candidate", args.candidate,
                            args.candidate_int8_until)):
        if i8 is not None and prec != "int8":
            raise SystemExit(
                f"--{side}_int8_until requires --{side} int8 (got {prec})")
        if i8 is not None:
            # and the depth: an out-of-range K would otherwise fail the
            # eval after the training phase
            from aaclip_tpu_torch.core.config import get_config
            layers = get_config(args.model_name).vision.layers
            if not 0 <= i8 <= layers:
                raise SystemExit(
                    f"--{side}_int8_until {i8} out of range for the "
                    f"{layers}-layer {args.model_name} tower")

    base_tag, cand_tag = _tags(args)

    if args.compare_only:
        tables, scores = {}, {}
        for tag in (base_tag, cand_tag):
            hits = sorted(glob.glob(
                os.path.join(args.compare_only, f"ab__{tag}__results_*.csv")),
                key=_snap_epoch)
            if len(hits) != 1:
                raise SystemExit(
                    f"need exactly one ab__{tag}__results_*.csv under "
                    f"{args.compare_only}, found {len(hits)} — a reused "
                    "workdir with multiple stashes can silently pair "
                    "tables from different runs; clean it up first")
            tables[tag] = read_table(hits[0])
            sc = hits[0].replace("__results_", "__scores_")
            if os.path.exists(sc):
                scores[tag] = read_scores(sc)
        verdict(tables, scores, args, root=args.compare_only, keep=True)
        return

    from aaclip_tpu_torch import test as test_cli
    from aaclip_tpu_torch.data.registry import DATASETS
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.train import cli as train_cli

    root = args.workdir or tempfile.mkdtemp(prefix="aaclip_ab_")
    class_names = tuple(DATASETS["MVTec"].class_names[:args.n_classes])
    data_root, meta_root = make_synthetic_dataset(
        root, img_px=args.img_size, class_names=class_names,
        n_normal=args.n_normal, n_anomalous=args.n_anomalous,
        hard=args.hard)
    os.environ["AACLIP_DATA"] = data_root
    os.environ["AACLIP_METADATA"] = meta_root
    n_imgs = args.n_classes * (args.n_normal + args.n_anomalous)
    print(f"synthetic dataset under {root}: {n_imgs} images "
          f"({args.n_classes} classes x {args.n_normal}+{args.n_anomalous}"
          f"{', hard' if args.hard else ''})", flush=True)

    common = [
        "--model_name", args.model_name, "--img_size", str(args.img_size),
        "--dataset", "MVTec", "--num_workers", str(args.num_workers),
    ]
    if args.levels is not None:
        common += ["--levels"] + [str(v) for v in args.levels]
    if args.text_adapt_until is not None:
        common += ["--text_adapt_until", str(args.text_adapt_until)]
    if args.image_adapt_until is not None:
        common += ["--image_adapt_until", str(args.image_adapt_until)]
    save = os.path.join(root, "ckpt_ab")
    t0 = time.time()
    train_cli.main(common + [
        "--precision", "bf16", "--save_path", save,
        "--training_mode", "full_shot",
        "--text_epoch", "1", "--image_epoch", "1",
        "--text_batch_size", str(args.text_batch_size),
        "--image_batch_size", str(args.image_batch_size),
        "--device_augment",
    ], device=device)
    t1 = time.time()
    print(f"train (1+1 epoch bf16): {t1 - t0:.0f}s", flush=True)

    tables, scores = {}, {}
    for tag, prec, until, i8 in (
            (base_tag, args.baseline, args.baseline_bf16_until,
             args.baseline_int8_until),
            (cand_tag, args.candidate, args.candidate_bf16_until,
             args.candidate_int8_until)):
        ts = time.time()
        extra = ["--bf16_until", str(until)] if until is not None else []
        if i8 is not None:
            extra += ["--int8_until", str(i8)]
        test_cli.main(common + extra + [
            "--precision", prec, "--save_path", save,
            "--batch_size", str(args.eval_batch_size),
            "--aupro", "--csv", "--dump_scores",
        ], device=device)
        # the evaluation CLI writes results_<epoch>.csv / scores_<epoch>.csv
        # into save_path; stash them under tag-suffixed names so the second
        # eval can't clobber them
        for kind in ("results", "scores"):
            csvs = sorted((f for f in os.listdir(save)
                           if f.startswith(f"{kind}_") and f.endswith(".csv")
                           and "__" not in f), key=_snap_epoch)
            if not csvs:
                raise RuntimeError(f"{tag}: no {kind}_*.csv under {save}")
            stash = os.path.join(save, f"ab__{tag}__{csvs[-1]}")
            shutil.move(os.path.join(save, csvs[-1]), stash)
            for leftover in csvs[:-1]:  # earlier-epoch tables: not compared
                os.remove(os.path.join(save, leftover))
            if kind == "results":
                tables[tag] = read_table(stash)
                print(f"eval {tag}: {time.time() - ts:.0f}s\n"
                      + test_cli.format_table(tables[tag]["columns"],
                                              tables[tag]["rows"]),
                      flush=True)
            else:
                scores[tag] = read_scores(stash)

    verdict(tables, scores, args, root=root,
            keep=args.keep or args.workdir is not None)


def _spearman(x, y):
    """Spearman rho with average-rank ties (numpy only)."""
    import numpy as np

    def rank(v):
        v = np.asarray(v, dtype=np.float64)
        order = np.argsort(v, kind="stable")
        r = np.empty(len(v))
        r[order] = np.arange(1, len(v) + 1, dtype=np.float64)
        # average ties
        for val in np.unique(v):
            m = v == val
            if m.sum() > 1:
                r[m] = r[m].mean()
        return r

    rx, ry = rank(x), rank(y)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = np.sqrt((rx * rx).sum() * (ry * ry).sum())
    return float((rx * ry).sum() / denom) if denom else 1.0


def verdict(tables, scores, args, root, keep):
    import numpy as np

    base_tag, cand_tag = _tags(args)
    a, b = tables[base_tag], tables[cand_tag]
    cols = a["columns"]
    # one image-level rank flip, derived from the dataset actually built
    flip = 100.0 / (args.n_normal * args.n_anomalous)
    print(f"\nper-column max |{base_tag} - {cand_tag}| (points):")
    failures = []
    for j, col in enumerate(cols[1:], 1):
        # NaN cells skipped, as pandas' max skips them
        d = np.nanmax([abs(ra[j] - rb[j])
                       for ra, rb in zip(a["rows"], b["rows"])])
        is_pixel = "pixel" in col.lower() or "aupro" in col.lower()
        if args.strict:
            tol, unit = 0.0, "strict"
        elif is_pixel:
            tol, unit = args.pixel_tol, f"pixel tol {args.pixel_tol}"
        else:
            tol = args.image_flips * flip
            unit = f"{args.image_flips} flips x {flip:.4g}"
        ok = d <= tol
        print(f"  {col}: {d:.2f} (allowed {tol:.2f} = {unit}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(col)

    # rank correlation over the per-image scores, if both dumps exist
    if base_tag in scores and cand_tag in scores:
        sa, sb = sorted(scores[base_tag]), sorted(scores[cand_tag])
        if [r[:2] for r in sa] != [r[:2] for r in sb]:
            failures.append("score-file-mismatch")
            print("  per-image score files differ between runs — "
                  "cannot correlate")
        else:
            pooled = _spearman([r[2] for r in sa], [r[2] for r in sb])
            worst, worst_cls = 2.0, None
            for cls in sorted({r[0] for r in sa}):
                rho = _spearman([r[2] for r in sa if r[0] == cls],
                                [r[2] for r in sb if r[0] == cls])
                if rho < worst:
                    worst, worst_cls = rho, cls
            print(f"  image-score Spearman rho: pooled {pooled:.4f}, "
                  f"worst class {worst:.4f} ({worst_cls}) "
                  f"(min {args.min_rho})")
            if min(pooled, worst) < args.min_rho:
                failures.append("spearman-rho")
    else:
        print("  (no per-image score dumps stashed — rank correlation "
              "skipped)")

    if failures:
        print(f"\nDIFFERING CELLS ({base_tag} vs {cand_tag}):")
        for j, col in enumerate(cols):
            for i, (ra, rb) in enumerate(zip(a["rows"], b["rows"])):
                if ra[j] != rb[j]:
                    print(f"  row {i} col {col}: {ra[j]} vs {rb[j]}")
        print(f"\nartifacts kept under {root}")
        raise SystemExit(f"PRECISION A/B: out of tolerance: {failures}")
    print("\nPRECISION A/B OK: " + (
        "tables identical to every reported digit" if args.strict else
        f"pixel metrics within {args.pixel_tol} points, image metrics "
        f"within {args.image_flips} rank flips of the {flip:.4g}-point "
        "eval granularity, score ranking preserved"))
    if not keep:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()

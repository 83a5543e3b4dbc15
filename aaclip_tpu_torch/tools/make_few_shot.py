"""Generate {K}-shot.jsonl metadata files from a dataset's full-shot.jsonl.

The reference expects user-generated few-shot files (not shipped); this
utility creates them deterministically: K samples per class, preferring
normal samples first (anomaly-free support sets are the common few-shot
protocol), seeded for reproducibility. The files go under the port's
``data/datasets.py::metadata_root()`` (``AACLIP_METADATA`` redirects it),
where ``python -m aaclip_tpu_torch.train --training_mode few_shot --shot
K`` and ``python -m aaclip_tpu_torch.test --memory_bank --shot K`` read
them; the draws are the JAX package's tool's, so both write the same
bytes.

Usage:
    python -m aaclip_tpu_torch.tools.make_few_shot --dataset VisA \
        --shots 1 2 4 32 --seed 111
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None, *, device=None):
    """``device`` is accepted for the tools' common signature; the files
    are written on the host."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--shots", type=int, nargs="+", default=[1, 2, 4, 32])
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--include_anomalous", action="store_true",
                        help="sample from all records, not just normals")
    args = parser.parse_args(argv)

    from aaclip_tpu_torch.data.datasets import metadata_root

    meta_dir = os.path.join(metadata_root(), args.dataset)
    full = os.path.join(meta_dir, "full-shot.jsonl")
    records = [json.loads(l) for l in open(full) if l.strip()]
    by_class = {}
    for r in records:
        by_class.setdefault(r["class_name"], []).append(r)

    for shot in args.shots:
        rng = np.random.default_rng(np.random.SeedSequence([args.seed, shot]))
        out = []
        for cls, recs in by_class.items():
            normal = [r for r in recs if not r["label"]]
            anomalous = [r for r in recs if r["label"]]
            if args.include_anomalous:
                # a copy: shuffling by_class's list in place would make
                # each K-shot file depend on which other --shots ran first
                pool = list(recs)
                rng.shuffle(pool)
                picked = pool[:shot]
            else:
                rng.shuffle(normal)
                picked = normal[:shot]
                if len(picked) < shot:
                    rng.shuffle(anomalous)
                    picked += anomalous[:shot - len(picked)]
            out.extend(picked)
            if len(picked) < shot:
                print(f"WARNING: class {cls!r} has only {len(picked)} "
                      f"records for {shot}-shot (truncated support set)")
        path = os.path.join(meta_dir, f"{shot}-shot.jsonl")
        with open(path, "w") as f:
            for r in out:
                f.write(json.dumps(r) + "\n")
        print(f"wrote {path}: {len(out)} records")


if __name__ == "__main__":
    main()

"""Compare a ``test.log`` of the evaluation CLI against the reference's
committed golden log (its ``results/test.log``), the regression oracle.

Parses the per-class metric tables from both logs and prints a per-class /
per-metric delta table plus the max absolute deviation, exiting non-zero
when any Average-row metric differs by more than --tolerance. The JAX
package's ``tools/compare_golden.py``, copied: the same parser, table and
exit codes.

Usage:
    python -m aaclip_tpu_torch.tools.compare_golden --ours ckpt/run/test.log \
        --golden REFERENCE/results/test.log --golden_index 0
(``--golden_index`` selects the dataset: golden tables appear in the
reference run's dataset order.)
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

METRICS = ["pixel AUC", "pixel AP", "image AUC", "image AP"]


def parse_tables(text: str) -> List[Dict[str, Dict[str, float]]]:
    """Extract every results table: list of {class_name: {metric: value}}."""
    tables = []
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if "class name" in line and "pixel AUC" in line:
            aupro = "AUPRO" in line
            names = METRICS + (["pixel AUPRO"] if aupro else [])
            table: Dict[str, Dict[str, float]] = {}
            for row in lines[i + 1:]:
                parts = row.split()
                # strip any "INFO:" style prefix tokens glued by logging
                while parts and parts[0].startswith(("INFO", "DEBUG")):
                    parts = parts[1:]
                if len(parts) < 5:
                    break
                nums = parts[-len(names):]
                name = " ".join(parts[: len(parts) - len(nums)])
                try:
                    vals = [float(x) for x in nums]
                except ValueError:
                    break
                table[name] = dict(zip(names, vals))
            if table:
                tables.append(table)
    return tables


def main(argv=None, *, device=None):
    """``device`` is accepted for the tools' common signature; the
    comparison runs on the host."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--ours", required=True)
    parser.add_argument("--golden", default=None,
                        help="the reference checkout's results/test.log")
    parser.add_argument("--table_index", type=int, default=-1,
                        help="which of our tables to use (default: last)")
    parser.add_argument("--golden_index", type=int, default=0,
                        help="which golden table (datasets appear in run "
                             "order)")
    parser.add_argument("--tolerance", type=float, default=0.2,
                        help="allowed Average-row deviation (points)")
    args = parser.parse_args(argv)
    if args.golden is None:
        parser.error("--golden: pass the reference checkout's "
                     "results/test.log")

    ours = parse_tables(open(args.ours).read())
    golden = parse_tables(open(args.golden).read())
    if not ours or not golden:
        print("could not parse tables", file=sys.stderr)
        return 2
    o = ours[args.table_index]
    g = golden[args.golden_index]

    shared = [c for c in g if c in o]
    if "Average" not in shared:
        # a regression oracle must not pass vacuously: a truncated log
        # (run killed mid-eval) has class rows but no Average entry
        print("no shared 'Average' row — truncated or mismatched tables",
              file=sys.stderr)
        return 2
    # compare AUPRO too when both tables carry it (--aupro runs)
    metrics = METRICS + (["pixel AUPRO"]
                         if all("pixel AUPRO" in t["Average"]
                                for t in (o, g)) else [])
    print(f"{'class':20s} " + " ".join(f"{m:>12s}" for m in metrics))
    worst = 0.0
    avg_worst = 0.0
    for cls in shared:
        deltas = [o[cls].get(m, float('nan')) - g[cls].get(m, float('nan'))
                  for m in metrics]
        print(f"{cls:20s} " + " ".join(f"{d:>+12.2f}" for d in deltas))
        for m, d in zip(metrics, deltas):
            if d == d:
                worst = max(worst, abs(d))
                if cls == "Average":
                    avg_worst = max(avg_worst, abs(d))
    print(f"\nmax |delta| any row: {worst:.2f}; Average row: {avg_worst:.2f} "
          f"(tolerance {args.tolerance})")
    return 0 if avg_worst <= args.tolerance else 1


if __name__ == "__main__":
    sys.exit(main())

"""The int8-vs-bf16 task-metric A/B: ``tools/precision_ab.py`` with its
original defaults (baseline bf16, candidate int8, 8+8 images per class),
as the JAX package's ``tools/int8_ab.py`` shim keeps them.

    python -m aaclip_tpu_torch.tools.int8_ab [precision_ab flags]
"""

from __future__ import annotations

import sys

from aaclip_tpu_torch.tools import precision_ab


def main(argv=None, *, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # the original harness built 8+8 images per class; keep that default
    if "--n_normal" not in argv:
        argv += ["--n_normal", "8"]
    if "--n_anomalous" not in argv:
        argv += ["--n_anomalous", "8"]
    precision_ab.main(argv, device=device)


if __name__ == "__main__":
    main()

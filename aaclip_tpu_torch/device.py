"""Device selection for the port's entry points.

``None`` means the card: the port runs on CUDA unless the caller names the
CPU explicitly (the tests do). There is no silent fallback to the CPU.
"""

from __future__ import annotations

import os
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (``cuda:LOCAL_RANK`` under ``torchrun``, one
    card per process), raising when no card is present; any other value is
    taken as given, and a CUDA device is checked to exist."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = "cuda" if local is None else f"cuda:{int(local)}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "device='cpu' is passed explicitly")
    return dev


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi`` reports
    them (for example ``NVIDIA H100 80GB HBM3, 700.00 W``): every timing
    is printed beside it, since a card set below its maximum power runs
    slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]

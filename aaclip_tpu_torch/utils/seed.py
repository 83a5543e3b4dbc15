"""Seeding of the host and device random number generators."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def setup_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's generators (every device's).
    ``PYTHONHASHSEED`` takes effect in child processes only: CPython reads
    it at start-up."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)

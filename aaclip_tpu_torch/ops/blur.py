"""Gaussian blur as a precomputed reflect-padded banded matrix.

Reproduces ``kornia.filters.gaussian_blur2d(x, (k, k), (s, s))`` (default
``border_type='reflect'``): a separable Gaussian whose 1-D kernel is
``exp(-(j - (k-1)/2)^2 / (2 s^2))`` normalized to sum one. The score maps
are tiny (37x37 at 518 px), so the blur is two [n, n] matmuls, and being a
matrix it composes exactly with the bilinear upsample matrix
(ops/similarity.py folds them together).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=32)
def gaussian_kernel_1d(kernel_size: int, sigma: float) -> np.ndarray:
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _reflect_index(i: int, n: int) -> int:
    """'reflect' padding index (edge not repeated), torch/kornia semantics."""
    if n == 1:
        return 0
    period = 2 * n - 2
    i = i % period
    return i if i < n else period - i


@functools.lru_cache(maxsize=32)
def gaussian_blur_matrix(n: int, kernel_size: int, sigma: float) -> np.ndarray:
    """[n, n] matrix applying a reflect-padded 1-D Gaussian blur."""
    g = gaussian_kernel_1d(kernel_size, sigma)
    r = kernel_size // 2
    B = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for tap in range(kernel_size):
            B[i, _reflect_index(i + tap - r, n)] += g[tap]
    return B


# Domain-dependent blur settings (kernel size, sigma).
DOMAIN_BLUR = {
    "Industrial": (7, 1.0),
    "Medical": (9, 1.5),
}

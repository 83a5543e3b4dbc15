"""1-D interpolation as dense matrices, so a resize is
``A_rows @ X @ A_cols^T`` and composes exactly with the blur matrix.

``bilinear_matrix(align_corners=True)`` reproduces
``F.interpolate(mode='bilinear', align_corners=True)``. ``bicubic_matrix``
is the positional-embedding resize of the checkpoint loader
(``core/params.py::resize_pos_embed``), in numpy on the host.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def bilinear_matrix(in_size: int, out_size: int,
                    align_corners: bool = True) -> np.ndarray:
    """[out_size, in_size] 1-D bilinear interpolation matrix."""
    A = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        A[:, 0] = 1.0
        return A
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = (i + 0.5) * in_size / out_size - 0.5
            src = min(max(src, 0.0), in_size - 1)
        i0 = min(int(np.floor(src)), in_size - 2)
        w = src - i0
        A[i, i0] += 1.0 - w
        A[i, i0 + 1] += w
    return A


def _cubic_weight(x: float, a: float) -> float:
    """Cubic convolution kernel."""
    x = abs(x)
    if x <= 1.0:
        return (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0
    if x < 2.0:
        return a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a
    return 0.0


@functools.lru_cache(maxsize=64)
def bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] 1-D bicubic matrix matching torch
    ``F.interpolate(mode='bicubic', align_corners=False, antialias=True)``,
    the reference's pos-embed resize: the PIL-style a=-0.5 kernel, whose
    out-of-range taps are discarded and the remaining weights renormalised,
    and whose support widens by the scale factor when downscaling. torch's
    default (``antialias=False``) is another kernel even when upscaling
    (a=-0.75, edge-clamped taps, a fixed 4-tap window), which is why the
    loader does not call ``F.interpolate`` with its defaults."""
    A = np.zeros((out_size, in_size), dtype=np.float64)
    a = -0.5
    scale = max(in_size / out_size, 1.0)
    support = 2.0 * scale
    invscale = 1.0 / scale
    for i in range(out_size):
        center = (i + 0.5) * in_size / out_size
        lo = max(0, int(center - support + 0.5))
        hi = min(in_size, int(center + support + 0.5))
        w = [_cubic_weight((j - center + 0.5) * invscale, a)
             for j in range(lo, hi)]
        total = sum(w)
        for j, wj in zip(range(lo, hi), w):
            A[i, j] += wj / total
    return A.astype(np.float32)


def resize_bicubic_2d(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Bicubic resize of the last two axes on the host (numpy, float64
    products, fp32 result)."""
    Ah = bicubic_matrix(x.shape[-2], out_hw[0]).astype(np.float64)
    Aw = bicubic_matrix(x.shape[-1], out_hw[1]).astype(np.float64)
    y = np.einsum("Oh,...hw->...Ow", Ah, x.astype(np.float64))
    y = np.einsum("Pw,...Ow->...OP", Aw, y)
    return y.astype(np.float32)

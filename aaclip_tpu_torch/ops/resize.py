"""1-D bilinear interpolation as a dense matrix, so a resize is
``A_rows @ X @ A_cols^T`` and composes exactly with the blur matrix.

``bilinear_matrix(align_corners=True)`` reproduces
``F.interpolate(mode='bilinear', align_corners=True)``.
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

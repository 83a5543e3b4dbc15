"""Test-time image and mask transforms (the reference's torchvision
pipeline, dataset/__init__.py:127-142): bicubic resize to ``img_size``,
then either raw uint8 CHW (normalised on the card inside the patch
embedding, ``ops/preprocess.py``) or the CLIP mean/std normalisation on
the host; masks nearest-resized and binarised (``!= 0``). Decoding and
resizing are ``data/image.py``'s, PIL's pixels without PIL for PNG files.
The training transforms come with the training CLI.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from aaclip_tpu_torch.data import image
from aaclip_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD


def to_uint8_chw(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> [3, H, W] uint8."""
    return np.ascontiguousarray(np.asarray(img, np.uint8).transpose(2, 0, 1))


def normalize_uint8_chw(chw: np.ndarray) -> np.ndarray:
    """uint8 [3, H, W] -> float32 CLIP-normalised, with the reference's
    elementwise ops (``/ 255``, ``- mean``, ``/ std``)."""
    x = chw.astype(np.float32) / 255.0
    return (x - CLIP_MEAN[:, None, None]) / CLIP_STD[:, None, None]


def load_rgb_chw(path: str, size: int, uint8: bool = False) -> np.ndarray:
    """Decode + bicubic resize -> [3, size, size], uint8 or normalised
    float32."""
    chw = to_uint8_chw(image.resize_bicubic(image.load_rgb(path), size))
    return chw if uint8 else normalize_uint8_chw(chw)


def load_mask_binarized(path: str, size: int) -> np.ndarray:
    """Decode as gray + nearest resize + binarise -> float32 [1, size,
    size]."""
    m = image.resize_nearest(image.load_gray(path), size)
    return (m != 0).astype(np.float32)[None]


def _mask_for(mask_path: Optional[str], img_size: int, label: int,
              dtype=np.float32) -> np.ndarray:
    """Ground-truth mask: the binarised file for anomalous samples, zeros
    for normal ones. An anomalous record without a mask_path is malformed
    metadata and raises (a silent all-zero mask would corrupt the pixel
    metrics; the reference indexes ``meta['mask_path']`` and crashes
    too)."""
    if label:
        if not mask_path:
            raise ValueError(
                "anomalous sample (label=1) without a mask_path — "
                "malformed metadata record")
        return load_mask_binarized(mask_path, img_size).astype(dtype)
    return np.zeros((1, img_size, img_size), dtype)


def preprocess_test(img_path: str, mask_path: Optional[str], img_size: int,
                    label: int, uint8: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic test-time transform; ``uint8=True`` leaves the
    normalisation to the card."""
    img = load_rgb_chw(img_path, img_size, uint8=uint8)
    return img, _mask_for(mask_path, img_size, label)

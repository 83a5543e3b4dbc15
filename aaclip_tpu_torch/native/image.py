"""ctypes bindings of ``fast_image.cc``: decode (libpng, libjpeg) and
Pillow's resamplers bit for bit, to the uint8 arrays the test-time input
path needs (``data/transforms.py::load_rgb_chw`` and
``load_mask_binarized``). Each returns None where the library is
unavailable or the file is one it leaves to Python (16-bit PNG, CMYK
JPEG, another format: rc != 0); the caller then decodes with
``data/image.py``. The call releases the GIL, so the loader's threads
decode in parallel.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from aaclip_tpu_torch.native.build import load_image_lib


def image_native_available() -> bool:
    """Whether the decode library is built and loaded."""
    return load_image_lib() is not None


def load_rgb_resize_chw(path: str, size: int) -> Optional[np.ndarray]:
    """``Image.open(path).convert("RGB")``, Pillow's bicubic resize to
    ``size`` x ``size``, as uint8 [3, size, size]; or None."""
    lib = load_image_lib()
    if lib is None:
        return None
    out = np.empty((3, size, size), np.uint8)
    rc = lib.load_rgb_resize_chw(
        os.fsencode(path), ctypes.c_int(size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def load_gray_resize_nearest(path: str, size: int) -> Optional[np.ndarray]:
    """``Image.open(path).convert("L")``, Pillow's nearest resize to
    ``size`` x ``size``, as uint8 [size, size] (raw values; the caller
    binarises); or None."""
    lib = load_image_lib()
    if lib is None:
        return None
    out = np.empty((size, size), np.uint8)
    rc = lib.load_gray_resize_nearest(
        os.fsencode(path), ctypes.c_int(size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None

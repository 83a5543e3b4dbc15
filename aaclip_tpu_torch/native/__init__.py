"""The port's host libraries, bound by ctypes (``native/build.py`` builds
them with g++): ``fast_metrics.cc`` (AUROC/AP by one parallel sort and a
pass over the distinct score cuts; 4-connected component labelling, as
``scipy.ndimage.label``) and ``fast_image.cc`` (``native/image.py``).

Each binding returns None when its library is unavailable (no compiler,
no libjpeg/libpng headers for the image library, or ``AACLIP_NO_NATIVE``
set); the callers then take their numpy paths (``eval/metrics.py``,
``data/transforms.py``). The same C ABI as the JAX package's
``aaclip_tpu/native``, from a copy of its sources.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from aaclip_tpu_torch.native.build import build_info, load


def native_available() -> bool:
    """Whether the metrics library is built and loaded."""
    return load() is not None


def metrics_path() -> str:
    """"native" when ``auroc_ap`` and ``label_components`` run the
    library, else "numpy" (``eval/metrics.py``'s numpy and scipy path)."""
    return "native" if native_available() else "numpy"


def auroc_ap(labels: np.ndarray, scores: np.ndarray
             ) -> Optional[Tuple[float, float]]:
    """(AUROC, AP) of float64 ``scores`` against binary ``labels`` through
    the library, (NaN, NaN) when only one class is present, or None
    without the library. float64 end to end: a float32 cast would merge
    score differences below its ulp into ties the numpy path keeps."""
    lib = load()
    if lib is None:
        return None
    scores = np.ascontiguousarray(scores.reshape(-1), np.float64)
    labels = np.ascontiguousarray(labels.reshape(-1) != 0, np.uint8)
    if labels.size != scores.size:  # the library reads both to one length
        raise ValueError(f"auroc_ap: {labels.size} labels for "
                         f"{scores.size} scores")
    a, p = ctypes.c_double(), ctypes.c_double()
    rc = lib.auroc_ap(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(scores.size), ctypes.byref(a), ctypes.byref(p))
    if rc != 0:
        return float("nan"), float("nan")
    return a.value, p.value


def label_components(mask: np.ndarray) -> Optional[Tuple[np.ndarray, int]]:
    """(labels int32 [H, W], number of components) of the 4-connected
    components of ``mask != 0``, numbered in raster order of their first
    pixel as ``scipy.ndimage.label`` numbers them; None without the
    library."""
    lib = load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask != 0, np.uint8)
    h, w = mask.shape
    out = np.zeros((h, w), np.int32)
    n = lib.label_components(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(h), ctypes.c_int32(w),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, int(n)


__all__ = ["auroc_ap", "build_info", "label_components", "metrics_path",
           "native_available"]

"""Qualitative panels of ``test --visualize`` (the JAX package's
``aaclip_tpu/eval/visualize.py``, reference forward_utils.py:283-327):
per image, the image, its ground-truth mask and its anomaly map as JET
overlays, stacked vertically, written under ``{save_dir}/visualization/
{dataset}/{class}/`` with the image's path flattened (``/`` -> ``_``).

JAX's version reads, resizes, colours and writes through cv2; the port
imports no cv2 and rebuilds each step as cv2 computes it:

* the image is decoded as ``data/image.py`` decodes it (numpy for PNG,
  PIL for other formats), RGB as ``cv2.imread`` + ``COLOR_BGR2RGB``;
* ``resize_linear`` is ``cv2.resize``'s default ``INTER_LINEAR`` on uint8
  bit for bit (``INTER_RESIZE_COEF_BITS`` = 11 fixed-point weights at
  half-pixel centres, no antialias, and the vectorised rounding of its
  vertical pass);
* ``JET`` is ``COLORMAP_JET``'s 256-entry table, in cv2's BGR order;
* the blend is ``(0.5 * img + 0.5 * coloured).astype(uint8)``, which
  truncates, on the RGB image and the BGR colours, as JAX blends them;
* ``cv2.imwrite`` takes the RGB panel for BGR, so the file JAX writes
  has red and blue swapped; the port writes the same pixels: PNG through
  ``data/image.py``'s numpy + zlib encoder (lossless, so the decoded file
  equals cv2's), other formats through PIL, JPEG at cv2's default quality
  95 (two libjpeg encoders, so within a small tolerance of cv2's file).
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from aaclip_tpu_torch.data import image
from aaclip_tpu_torch.data.registry import DATASETS

_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
JPEG_QUALITY = 95  # cv2's IMWRITE_JPEG_QUALITY default


def _jet_table() -> np.ndarray:
    """cv2's ``COLORMAP_JET`` as uint8 [256, 3] in BGR order: three tents of
    slope 4 per step, clipped to [0, 255]. cv2 interpolates its table from
    float control points, which puts one entry off the tent: blue at 159
    is 1, not 2."""
    i = np.arange(256)
    red = np.minimum(4 * i - 382, 1148 - 4 * i)
    green = np.minimum(4 * i - 128, 892 - 4 * i)
    blue = np.minimum(4 * i + 128, 638 - 4 * i)
    blue[159] = 1
    return np.clip(np.stack([blue, green, red], 1), 0, 255).astype(np.uint8)


JET = _jet_table()


def _linear_taps(in_size: int, out_size: int, clamp_weight: bool):
    """cv2's INTER_LINEAR taps along one axis: source indices (i0, i1) and
    fixed-point weights (w0, w1) per output index. The source position is
    ``(d + 0.5) * in / out - 0.5`` in float32; horizontally a position
    outside the image takes the edge pixel whole (``clamp_weight``),
    vertically only the rows are clamped and the weights stay."""
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weight:
        f[(s < 0) | (s >= in_size - 1)] = 0
        s = np.clip(s, 0, in_size - 1)
    one = np.float32(1 << _COEF_BITS)
    w1 = np.rint(f * one).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * one).astype(np.int64)
    return (np.clip(s, 0, in_size - 1), np.clip(s + 1, 0, in_size - 1),
            w0, w1)


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` (``INTER_LINEAR``) of a uint8
    [h, w] or [h, w, c] image, bit for bit: the horizontal pass sums the
    two taps' products in integers, the vertical pass rounds as cv2's
    vectorised kernel does, ``((r0 >> 4) * w0 >> 16) + ((r1 >> 4) * w1 >>
    16)`` then ``(+ 2) >> 2``."""
    img = np.asarray(img, np.uint8)
    flat = img.ndim == 2
    x = img[..., None] if flat else img
    h, w = x.shape[:2]
    x0, x1, a0, a1 = _linear_taps(w, width, clamp_weight=True)
    y0, y1, b0, b1 = _linear_taps(h, height, clamp_weight=False)
    x = x.astype(np.int64)
    rows = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
    top = ((rows[y0] >> 4) * b0[:, None, None]) >> 16
    bottom = ((rows[y1] >> 4) * b1[:, None, None]) >> 16
    out = np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)
    return out[..., 0] if flat else out


def apply_scoremap(img: np.ndarray, scoremap: np.ndarray,
                   alpha: float = 0.5) -> np.ndarray:
    """``(alpha * img + (1 - alpha) * applyColorMap(scoremap, JET))
    .astype(uint8)``: ``scoremap`` uint8 [h, w] (cv2 reads a gray map
    replicated to 3 channels as that gray), its colours in cv2's BGR order
    against the RGB image, as JAX's ``apply_scoremap`` blends them."""
    return (alpha * img + (1 - alpha) * JET[scoremap]).astype(np.uint8)


def write_panel(path: str, panel: np.ndarray) -> None:
    """``cv2.imwrite(path, panel)``'s pixels: the panel's channels taken
    as BGR, so the file holds them reversed; PNG through the numpy
    encoder, other formats through PIL (JPEG at quality 95)."""
    rgb = np.ascontiguousarray(panel[..., ::-1])
    if os.path.splitext(path)[1].lower() == ".png":
        with open(path, "wb") as f:
            f.write(image.encode_png(rgb))
        return
    from PIL import Image

    Image.fromarray(rgb).save(path, quality=JPEG_QUALITY)


def _read_rgb(path: str):
    """The image as ``cv2.imread`` + ``COLOR_BGR2RGB`` gives it, or None
    where cv2's read would fail (a missing or undecodable file)."""
    try:
        return image.load_rgb(path)
    except (OSError, ValueError, RuntimeError):
        return None


def visualize(pixel_label: np.ndarray, pixel_preds: np.ndarray,
              file_names: List[str], save_dir: str, dataset_name: str,
              class_name: str) -> None:
    """One panel per image of a class (JAX's ``visualize``): the maps
    scaled to [0, 255] over the class (unless their max is already 1),
    the masks binarised; two paths that flatten to one name get numbered
    names (``stem.1.ext``), and the first writer of a name removes the
    numbered panels a previous run left for it."""
    preds = np.asarray(pixel_preds).astype(np.float64)
    if preds.max() != 1:
        span = preds.max() - preds.min()
        preds = (preds - preds.min()) / span if span else preds * 0
    preds_u8 = (preds * 255).astype(np.uint8)
    labels = np.asarray(pixel_label)
    labels = labels.reshape(labels.shape[0], *labels.shape[-2:])
    labels_u8 = ((labels != 0) * 255).astype(np.uint8)

    out_dir = os.path.join(save_dir, "visualization", dataset_name,
                           class_name)
    os.makedirs(out_dir, exist_ok=True)
    data_path = DATASETS[dataset_name].data_path
    size = preds_u8.shape[-2:]
    used: set = set()
    for idx, rel in enumerate(file_names):
        img = _read_rgb(os.path.join(data_path, rel))
        if img is None:
            continue
        img = resize_linear(img, size[1], size[0])
        panel = np.vstack([img, apply_scoremap(img, labels_u8[idx]),
                           apply_scoremap(img, preds_u8[idx])])
        fname = rel.replace("/", "_")
        stem, ext = os.path.splitext(fname)
        if fname in used:
            # two paths can flatten to one name: never overwrite a panel
            # of this run
            k = 1
            while f"{stem}.{k}{ext}" in used:
                k += 1
            fname = f"{stem}.{k}{ext}"
        else:
            # the first writer of a name drops the numbered panels of an
            # earlier run whose collisions no longer exist
            for old in glob.glob(os.path.join(
                    out_dir, glob.escape(stem) + ".[0-9]*" + ext)):
                os.unlink(old)
        used.add(fname)
        write_panel(os.path.join(out_dir, fname), panel)

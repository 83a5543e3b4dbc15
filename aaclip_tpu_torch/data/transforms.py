"""Image and mask transforms of the reference's torchvision pipeline
(dataset/__init__.py:30-142), on the host, as the JAX package's
``aaclip_tpu/data/transforms.py`` computes them:

* test: bicubic resize to ``img_size``, then either raw uint8 CHW
  (normalised on the card inside the patch embedding,
  ``ops/preprocess.py``) or the CLIP mean/std normalisation; masks
  nearest-resized and binarised (``!= 0``);
* train: colour jitter (brightness, contrast, saturation, each with
  probability 0.7 and a factor in U[0.5, 1.5]; image stage only) before
  the resize, and the joint geometric augment of image and mask:
  rotation (30 degrees, p 0.5), an integer translation (0.15 of the side,
  p 0.5), horizontal and vertical flips (p 0.5), nearest resampling, zero
  fill.

Test-time decoding and resizing (``load_rgb_chw``, and the masks of
both stages) go through the host library (``native/image.py``: libpng,
libjpeg and Pillow's resamplers in C++) when it is built, else, and for a
file it leaves to Python, through ``data/image.py`` (numpy for PNG, PIL
for other formats); both give Pillow's pixels, and ``DECODE_COUNTS``
counts the images each took. Training images are decoded by
``data/image.py`` (the colour jitter runs before the resize). The colour
jitter is Pillow's ``ImageEnhance`` chain in numpy, so a PNG dataset
needs no PIL.
The draws come from an explicit numpy Generator in the JAX package's
order, so a sample's pixels depend only on (seed, epoch, index, stage).
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import numpy as np

from aaclip_tpu_torch.data import image
from aaclip_tpu_torch.native import image as native_image
from aaclip_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD

# {"native" or "fallback": images and masks decoded that way}, for the
# evaluation CLI's log (the loader's threads add to it)
DECODE_COUNTS = {"native": 0, "fallback": 0}
_counts_lock = threading.Lock()


def _counted(native_result, fallback):
    """``native_result``, or ``fallback()`` where it is None; counted in
    ``DECODE_COUNTS``."""
    path = "fallback" if native_result is None else "native"
    with _counts_lock:
        DECODE_COUNTS[path] += 1
    return fallback() if native_result is None else native_result


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
    float32: the host library's, else ``data/image.py``'s (the same
    pixels)."""
    chw = _counted(native_image.load_rgb_resize_chw(path, size),
                   lambda: to_uint8_chw(image.resize_bicubic(
                       image.load_rgb(path), size)))
    return chw if uint8 else normalize_uint8_chw(chw)


def load_mask_binarized(path: str, size: int) -> np.ndarray:
    """Decode as gray + nearest resize + binarise -> float32 [1, size,
    size], through the host library or ``data/image.py``."""
    m = _counted(native_image.load_gray_resize_nearest(path, size),
                 lambda: image.resize_nearest(image.load_gray(path), size))
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


def _blend(degenerate: np.ndarray, img: np.ndarray,
           factor: float) -> np.ndarray:
    """Pillow's ``Image.blend(degenerate, img, factor)`` on uint8 arrays:
    the factor rounded to C float, ``degenerate + factor * (img -
    degenerate)`` in float (two roundings, no fused multiply-add), then
    truncated toward zero and clipped to [0, 255] (libImaging/Blend.c)."""
    a = np.float32(factor)
    base = degenerate.astype(np.float32)
    t = base + a * (img.astype(np.float32) - base)
    return np.clip(t, 0.0, 255.0).astype(np.uint8)


def jitter_chain(img: np.ndarray, fb: float, fc: float,
                 fs: float) -> np.ndarray:
    """Pillow's ``ImageEnhance`` Brightness(fb) -> Contrast(fc) ->
    Color(fs) on uint8 [H, W, 3], each enhancer built from the previous
    one's output; a factor of 1.0 skips its enhancer (the blend would
    return the image unchanged).

    Brightness blends with black; Contrast with the solid gray at
    ``int(mean + 0.5)``, the mean of ``convert("L")`` as ``ImageStat``
    takes it (an exact integer sum over the count, in double); Color with
    ``convert("L").convert("RGB")``."""
    x = img
    if fb != 1.0:
        x = _blend(np.zeros_like(x), x, fb)
    if fc != 1.0:
        gray = image.rgb_to_gray(x)
        mean = int(int(gray.sum(dtype=np.int64)) / gray.size + 0.5)
        x = _blend(np.full_like(x, mean), x, fc)
    if fs != 1.0:
        x = _blend(np.repeat(image.rgb_to_gray(x)[..., None], 3, axis=2), x,
                   fs)
    return x


def jitter_factors(rng: np.random.Generator, strength: float = 0.5,
                   p: float = 0.7) -> Tuple[float, float, float]:
    """Brightness, contrast and saturation factors: each enhancer drawn
    with probability ``p`` (then its factor ~ U[1 - strength, 1 +
    strength]), else 1.0, in that order (torchvision ColorJitter's
    distribution, the reference's fixed enhancer order)."""
    factors = []
    for _ in range(3):
        f = 1.0
        if rng.random() < p:
            f = float(rng.uniform(1.0 - strength, 1.0 + strength))
        factors.append(f)
    return tuple(factors)


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 strength: float = 0.5, p: float = 0.7) -> np.ndarray:
    """The JAX package's ``color_jitter`` (Pillow's pixels) on uint8
    [H, W, 3]."""
    return jitter_chain(img, *jitter_factors(rng, strength, p))


def _affine_nearest(channels: np.ndarray, angle_deg: float,
                    translate: Tuple[float, float]) -> np.ndarray:
    """Nearest-neighbour inverse-mapped affine (rotation about the centre,
    then translation), zero fill, on [C, H, W]: torchvision's
    F.affine/F.rotate semantics. The expression order and float32
    arithmetic are the JAX package's: ``ys - ty - cy`` stays float32
    because a Python float is a weak scalar (NEP 50)."""
    C, H, W = channels.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    a = math.radians(angle_deg)
    cos_a, sin_a = math.cos(a), math.sin(a)
    ty, tx = translate
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    # inverse map: undo the translation, then rotate by -angle
    y0 = ys - ty - cy
    x0 = xs - tx - cx
    # a positive angle rotates counter-clockwise (torchvision)
    src_x = cos_a * x0 - sin_a * y0 + cx
    src_y = sin_a * x0 + cos_a * y0 + cy
    sx = np.rint(src_x).astype(np.int64)
    sy = np.rint(src_y).astype(np.int64)
    valid = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    sx = np.clip(sx, 0, W - 1)
    sy = np.clip(sy, 0, H - 1)
    out = channels[:, sy, sx]
    out *= valid[None]
    return out


def geometric_params(rng: np.random.Generator, H: int, W: int
                     ) -> Tuple[float, float, float, bool, bool]:
    """(angle, ty, tx, hflip, vflip) drawn in the reference's order:
    RandomRotation(30) p 0.5, RandomAffine(translate 0.15) p 0.5 with
    integer offsets, then the flips; 0.0 and False where not drawn."""
    angle = tx = ty = 0.0
    if rng.random() < 0.5:
        angle = float(rng.uniform(-30.0, 30.0))
    if rng.random() < 0.5:
        tx = float(np.rint(rng.uniform(-0.15 * W, 0.15 * W)))
        ty = float(np.rint(rng.uniform(-0.15 * H, 0.15 * H)))
    hflip = bool(rng.random() < 0.5)
    vflip = bool(rng.random() < 0.5)
    return angle, ty, tx, hflip, vflip


def apply_geometric(stacked: np.ndarray, angle: float, ty: float, tx: float,
                    hflip: bool, vflip: bool) -> np.ndarray:
    """The augment with fixed parameters on [C, H, W]: the rotation and
    the translation as two separate resamples (torchvision applies them
    so), then the flips."""
    if angle != 0.0:
        stacked = _affine_nearest(stacked, angle, (0.0, 0.0))
    if ty or tx:  # a zero translation is the identity
        stacked = _affine_nearest(stacked, 0.0, (ty, tx))
    if hflip:
        stacked = stacked[:, :, ::-1]
    if vflip:
        stacked = stacked[:, ::-1, :]
    return np.ascontiguousarray(stacked)


def joint_geometric_augment(img: np.ndarray, mask: np.ndarray,
                            rng: np.random.Generator
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """The joint augment of image [3, H, W] and mask [1, H, W]
    (reference dataset/__init__.py:30-39, 89-94)."""
    stacked = np.concatenate([img, mask], axis=0)
    H, W = stacked.shape[-2:]
    stacked = apply_geometric(stacked, *geometric_params(rng, H, W))
    return stacked[:3], stacked[3:4]


def preprocess_test(img_path: str, mask_path: Optional[str], img_size: int,
                    label: int, uint8: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic test-time transform; ``uint8=True`` leaves the
    normalisation to the card."""
    img = load_rgb_chw(img_path, img_size, uint8=uint8)
    return img, _mask_for(mask_path, img_size, label)


def preprocess_train(img_path: str, mask_path: Optional[str], img_size: int,
                     label: int, rng: Optional[np.random.Generator],
                     text_stage: bool, geometric: bool = True,
                     uint8: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Training transform; ``text_stage=True`` skips the colour jitter
    (reference dataset/__init__.py:41-52). ``geometric=False`` leaves the
    joint geometric augment to the card (``ops/augment.py``); with
    ``uint8=True`` (which needs it) the image is the raw post-jitter
    pixels and the mask uint8 {0, 1}, normalised on the card."""
    rgb = image.load_rgb(img_path)
    if not text_stage:
        rgb = color_jitter(rgb, rng)
    chw = to_uint8_chw(image.resize_bicubic(rgb, img_size))
    if uint8:
        if geometric:
            raise ValueError("uint8 training inputs leave the geometric "
                             "augment to the card: pass geometric=False")
        return chw, _mask_for(mask_path, img_size, label, np.uint8)
    img = normalize_uint8_chw(chw)
    mask = _mask_for(mask_path, img_size, label)
    if not geometric:
        return img, mask
    return joint_geometric_augment(img, mask, rng)

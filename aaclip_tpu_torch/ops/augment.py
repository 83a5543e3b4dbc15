"""The training batch's joint geometric augment and colour jitter on the
card (the JAX package's ``aaclip_tpu/ops/augment.py``), in plain torch.

The same transforms as the host path (``data/transforms.py``): rotation
(30 degrees, p 0.5), integer translation (0.15 of the side, p 0.5), H and
V flips (p 0.5), nearest resampling with zero fill, applied to image and
mask together; Pillow's Brightness -> Contrast -> Color chain. Given the
same parameters the card's output equals the host's bit for bit: the
rotation's cosine and sine are taken in float64 and rounded to float32,
as numpy rounds the host's ``math.cos``; the index arithmetic is float32
in the host's expression order with ``round`` (half to even) for
``np.rint``; every division is a true one (``_div``); each blend is a
float32 multiply then add (no fused multiply-add), truncated and
clipped, as Pillow's C does. The rotation,
translation and flips compose into one gather: the translation offsets are
integers and the flips index reversals, so the rotation's own indices are
read at the translated coordinates.

The draws come from an explicit ``torch.Generator`` on the card (one per
batch, ``augment_generator``), so they match the host's only in
distribution."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from aaclip_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD

AUG_SEED_XOR = 0x5EED


def augment_generator(seed: int, stage: int, epoch: int, it: int,
                      device) -> torch.Generator:
    """The generator of one batch's draws, seeded from ``(seed ^ 0x5EED,
    stage, epoch, it)`` (JAX's ``train.py`` folds its augment key from the
    same four)."""
    state = np.random.SeedSequence(
        [seed ^ AUG_SEED_XOR, stage, epoch, it]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


# ---------------------------------------------------------------------------
# Geometric augment


def _rotation(angle_deg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (cos, sin) of float64 degrees: ``math.cos(math.radians(a))``
    in float64, rounded to float32."""
    a = angle_deg.double() * (math.pi / 180.0)
    return torch.cos(a).float(), torch.sin(a).float()


def _grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ys = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    return ys.expand(H, W), xs.expand(H, W)


def _rotate_indices(y, x, cos_a, sin_a, H: int, W: int):
    """(sy, sx, valid) of the inverse-mapped nearest rotation about the
    centre, read at float32 coordinates ``y``, ``x`` (the host's
    ``_affine_nearest`` arithmetic)."""
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    y0 = y - cy
    x0 = x - cx
    src_x = cos_a * x0 - sin_a * y0 + cx
    src_y = sin_a * x0 + cos_a * y0 + cy
    sx = torch.round(src_x).long()
    sy = torch.round(src_y).long()
    valid = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    return sy.clamp(0, H - 1), sx.clamp(0, W - 1), valid


def _nearest_affine_one(chans: torch.Tensor, angle_deg: float, ty: float,
                        tx: float) -> torch.Tensor:
    """Rotation about the centre after the translation (ty, tx), zero
    fill, on one [C, H, W]: ``data/transforms.py::_affine_nearest`` (the
    JAX package's ``_nearest_affine_one``)."""
    C, H, W = chans.shape
    cos_a, sin_a = _rotation(torch.tensor(float(angle_deg),
                                          dtype=torch.float64,
                                          device=chans.device))
    ys, xs = _grid(H, W, chans.device)
    sy, sx, valid = _rotate_indices(ys - ty, xs - tx, cos_a, sin_a, H, W)
    return chans[:, sy, sx] * valid.to(chans.dtype)


def geometric_params(gen: torch.Generator, B: int, H: int, W: int):
    """Per sample (angle [B] float64, ty, tx [B] float32 integers, hflip,
    vflip [B] bool), each stage drawn with probability 0.5 as
    ``data/transforms.py::geometric_params`` draws it."""
    u = torch.rand(B, 7, generator=gen, device=gen.device,
                   dtype=torch.float64)
    angle = torch.where(u[:, 0] < 0.5, -30.0 + 60.0 * u[:, 1], 0.0)
    trans = u[:, 2] < 0.5
    tx = torch.round(-0.15 * W + 0.3 * W * u[:, 3])
    ty = torch.round(-0.15 * H + 0.3 * H * u[:, 4])
    tx = torch.where(trans, tx, 0.0).float()
    ty = torch.where(trans, ty, 0.0).float()
    return angle, ty, tx, u[:, 5] < 0.5, u[:, 6] < 0.5


def geometric_indices(params, H: int, W: int):
    """(flat source index [B, H*W], valid [B, H, W]) of the composed
    rotation -> translation -> H flip -> V flip: the flips run last, so
    they remap the output coordinates first; the translation moves them
    by integers (zero outside); the rotation's indices are read there."""
    angle, ty, tx, hflip, vflip = params
    dev = angle.device
    cos_a, sin_a = (t[:, None, None] for t in _rotation(angle))
    ys, xs = _grid(H, W, dev)
    xs = torch.where(hflip[:, None, None], (W - 1) - xs, xs)
    ys = torch.where(vflip[:, None, None], (H - 1) - ys, ys)
    yt = ys - ty[:, None, None]
    xt = xs - tx[:, None, None]
    valid_t = (yt >= 0) & (yt < H) & (xt >= 0) & (xt < W)
    yt = yt.clamp(0, H - 1)
    xt = xt.clamp(0, W - 1)
    sy, sx, valid_r = _rotate_indices(yt, xt, cos_a, sin_a, H, W)
    return (sy * W + sx).reshape(-1, H * W), valid_t & valid_r


def geometric_augment(images: torch.Tensor, masks: torch.Tensor, params
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float path: images [B, 3, H, W], masks [B, H, W] with fixed
    ``params``; the gather of image and mask together, zero fill."""
    B, _, H, W = images.shape
    idx, valid = geometric_indices(params, H, W)
    stacked = torch.cat([images, masks[:, None].to(images.dtype)], 1)
    out = torch.gather(stacked.reshape(B, 4, H * W), 2,
                       idx[:, None].expand(B, 4, H * W)).reshape(B, 4, H, W)
    out = out * valid[:, None].to(out.dtype)
    return out[:, :3], out[:, 3].to(masks.dtype)


def geometric_augment_u8(images_u8: torch.Tensor, masks_u8: torch.Tensor,
                         params
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed path: uint8 images [B, 3, H, W] and masks [B, H, W]; each
    pixel's r, g, b and mask bytes gather as one int32 (a quarter of the
    float path's elements). Returns (uint8 images, uint8 masks, valid
    [B, H, W]); the caller normalises after the gather and applies
    ``valid`` (``normalize_valid``), which equals the float path's
    normalise-then-gather bit for bit."""
    B, _, H, W = images_u8.shape
    idx, valid = geometric_indices(params, H, W)
    packed = torch.cat([images_u8, masks_u8[:, None]], 1)        # [B,4,H,W]
    packed = packed.permute(0, 2, 3, 1).contiguous().view(torch.int32)
    g = torch.gather(packed.reshape(B, H * W), 1, idx)
    g = g.view(torch.uint8).reshape(B, H, W, 4).permute(0, 3, 1, 2)
    return g[:, :3], g[:, 3], valid


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as numpy divides: CUDA divides by a Python
    scalar as a product with its reciprocal, which can be an ulp off."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def normalize_valid(images_u8: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
    """uint8 [B, 3, H, W] -> float32 CLIP-normalised with the host's ops
    (``/ 255``, ``- mean``, ``/ std``), times ``valid`` (zero fill, as the
    host multiplies its gathered floats by the mask of valid sources)."""
    dev = images_u8.device
    mean = torch.from_numpy(CLIP_MEAN).to(dev)[None, :, None, None]
    std = torch.from_numpy(CLIP_STD).to(dev)[None, :, None, None]
    x = (_div(images_u8.float(), 255.0) - mean) / std
    return x * valid[:, None].float()


# ---------------------------------------------------------------------------
# Colour jitter


def _gray(x: torch.Tensor) -> torch.Tensor:
    """PIL ``convert("L")`` of [B, 3, H, W] integer values, int32
    [B, 1, H, W]."""
    r, g, b = (x[:, i:i + 1].int() for i in range(3))
    return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16


def _blend(base: torch.Tensor, img: torch.Tensor,
           f: torch.Tensor) -> torch.Tensor:
    """Pillow's blend on float32-held uint8 values: ``base + f * (img -
    base)`` (a multiply, then an add, each rounded), truncated, clipped."""
    t = base + f * (img - base)
    return t.clamp(0.0, 255.0).to(torch.uint8).float()


def jitter_chain(images_u8: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor,
                 fs: torch.Tensor) -> torch.Tensor:
    """Brightness(fb) -> Contrast(fc) -> Color(fs) on uint8 [B, 3, H, W]
    with float32 factors [B] (``data/transforms.py::jitter_chain``). A
    factor of 1.0 gives the image back unchanged, so the card runs all
    three where the host skips one."""
    B, _, H, W = images_u8.shape
    f = [t.float().reshape(B, 1, 1, 1) for t in (fb, fc, fs)]
    x = images_u8.float()
    x = _blend(torch.zeros_like(x), x, f[0])
    # ImageStat's mean: an exact integer sum over the count, in double
    total = _gray(x).sum(dim=(1, 2, 3), dtype=torch.int64)
    mean = torch.floor(_div(total.double(), H * W) + 0.5).float()
    x = _blend(mean.reshape(B, 1, 1, 1).expand_as(x), x, f[1])
    x = _blend(_gray(x).float().expand_as(x), x, f[2])
    return x.to(torch.uint8)


def jitter_params(gen: torch.Generator, B: int, strength: float = 0.5,
                  p: float = 0.7):
    """(fb, fc, fs) float32 [B]: each enhancer drawn with probability
    ``p``, its factor ~ U[1 - strength, 1 + strength], else 1.0."""
    u = torch.rand(B, 6, generator=gen, device=gen.device,
                   dtype=torch.float64)
    return tuple(torch.where(u[:, 2 * k] < p,
                             1.0 - strength + 2 * strength * u[:, 2 * k + 1],
                             1.0).float() for k in range(3))


def color_jitter(gen: torch.Generator, images_u8: torch.Tensor
                 ) -> torch.Tensor:
    """The host ``color_jitter``'s distribution on a uint8 batch."""
    return jitter_chain(images_u8, *jitter_params(gen, images_u8.shape[0]))


# ---------------------------------------------------------------------------


def _params(gen, B: int, H: int, W: int, part: Tuple[int, int]):
    """The draws of ``part = (rank, size)``'s rows of a global batch of
    ``B * size`` (rows rank, rank + size, ..., as ``parallel/sharding.py::
    shard_rows`` deals them): the global batch's draws, so a row's draw
    does not depend on how many ranks share the batch."""
    rank, size = part
    params = geometric_params(gen, B * size, H, W)
    return tuple(p[rank::size] for p in params) if size > 1 else params


def make_device_augment(uint8_inputs: bool = False):
    """``augment(gen, images, masks, part=(0, 1)) -> (float32 images,
    float32 masks)`` for a batch: images [B, 3, H, W] and masks [B, H, W],
    with independent draws per sample from ``gen``; ``part = (rank, size)``
    takes these rows as rank ``rank``'s of a global batch of ``B * size``
    (``_params``). ``uint8_inputs=True`` takes raw uint8 pixels and {0, 1}
    masks, gathers them packed and normalises after, equal bit for bit to
    normalising first (the card then receives a quarter of the bytes)."""

    def augment_float(gen, images, masks, part=(0, 1)):
        B, _, H, W = images.shape
        return geometric_augment(images, masks, _params(gen, B, H, W, part))

    def augment_u8(gen, images_u8, masks_u8, part=(0, 1)):
        B, _, H, W = images_u8.shape
        img, mask, valid = geometric_augment_u8(
            images_u8, masks_u8, _params(gen, B, H, W, part))
        return normalize_valid(img, valid), mask.float() * valid.float()

    return augment_u8 if uint8_inputs else augment_float

"""Image decode and resize for the test-time input path, in numpy and the
standard library's ``zlib``: the same pixels PIL gives, without PIL.

The reference decodes with PIL and resizes with PIL's fixed-point
resamplers (torchvision ``Resize`` on PIL images, reference
dataset/__init__.py:44-66); the JAX package reproduces both bit for bit in
C++ (``aaclip_tpu/native/fast_image.cc``). Here:

* PNG decode: 8-bit (and 1/2/4-bit gray or palette), non-interlaced,
  filter types 0-4, colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray
  + alpha) and 6 (RGBA), with PIL's ``convert("RGB")`` / ``convert("L")``:
  alpha is dropped without compositing, gray is replicated, palettes are
  expanded, and RGB becomes L as ``(R*19595 + G*38470 + B*7471 + 0x8000)
  >> 16``. Rows filtered Average or Paeth depend on their left neighbour,
  so such images are unfiltered along anti-diagonals (all rows at once);
  images without them row by row.
* Other formats (VisA's JPEG, BTAD's BMP) go through PIL, imported inside
  the function; without PIL they raise and name the file.
* BICUBIC: Pillow's two-pass separable resample (horizontal, then
  vertical, uint8 rows in between), a = -0.5, support widened by the
  scale when downscaling, weights quantised to 22 fractional bits with
  +-0.5 rounding, accumulators seeded with the rounding constant.
* NEAREST (masks): Pillow's affine scale, the source coordinate
  accumulated in double from half a step and truncated.

``encode_png`` writes 8-bit gray or RGB with one filter type on every row
(None for the synthetic dataset).
"""

from __future__ import annotations

import functools
import io
import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PRECISION_BITS = 32 - 8 - 2  # Pillow's PRECISION_BITS
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# ---------------------------------------------------------------------------
# PNG


def _chunks(data: bytes, what: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or \
                zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{what}: truncated or corrupt PNG chunk "
                             f"{kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{what}: PNG ends without IEND")


def _unfilter_rows(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Rows filtered None, Sub or Up: one row at a time, each vectorised."""
    out = np.empty_like(raw)
    prev = np.zeros(raw.shape[1], np.uint8)
    for y in range(raw.shape[0]):
        r, f = raw[y], ftype[y]
        if f == 0:
            out[y] = r
        elif f == 1:
            out[y] = np.cumsum(r.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        else:
            out[y] = r + prev
        prev = out[y]
    return out


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _predict(ftype: np.ndarray, a: np.ndarray, b: np.ndarray,
             c: np.ndarray) -> np.ndarray:
    """The PNG predictor of each row's filter type (int16 neighbours:
    left ``a``, up ``b``, up-left ``c``; ``ftype`` broadcasts over them)."""
    return np.where(ftype == 1, a, np.where(
        ftype == 2, b, np.where(ftype == 3, (a + b) >> 1, np.where(
            ftype == 4, _paeth(a, b, c), 0))))


def _unfilter_diagonal(raw: np.ndarray, ftype: np.ndarray,
                       bpp: int) -> np.ndarray:
    """Any filter types: the pixels of one anti-diagonal depend only on the
    two before it (left, up, up-left), so each diagonal is one vectorised
    step over every row. The image is sheared first, diagonal ``d = y + x``
    at ``[d, y]``, so each step reads and writes contiguous slices."""
    h, stride = raw.shape
    W = stride // bpp
    n = h + W - 1
    y = np.arange(h)[:, None]
    diag = y + np.arange(W)[None, :]
    sheared = np.zeros((n, h, bpp), np.int16)
    sheared[diag, y] = raw.reshape(h, W, bpp)
    # two zero diagonals before the first, a zero row before the first
    out = np.zeros((n + 2, h + 1, bpp), np.int16)
    f = ftype.astype(np.int16)[:, None]
    for d in range(n):
        lo, hi = max(0, d - W + 1), min(h, d + 1)
        a = out[d + 1, lo + 1:hi + 1]  # left: previous diagonal, same row
        b = out[d + 1, lo:hi]          # up: previous diagonal, row above
        c = out[d, lo:hi]              # up-left
        out[d + 2, lo + 1:hi + 1] = (sheared[d, lo:hi]
                                     + _predict(f[lo:hi], a, b, c)) & 255
    return out[diag + 2, y + 1].astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes, what: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 [h, w, 1] (gray, gray + alpha) or [h, w, 3] (RGB,
    RGBA, palette), alpha dropped; ``what`` names the source in errors."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{what}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, what):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{what}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or interlace != 0 or not (
            depth == 8 or (depth in (1, 2, 4) and ctype in (0, 3))):
        raise ValueError(
            f"{what}: unsupported PNG layout (bit depth {depth}, colour "
            f"type {ctype}, interlace {interlace}); the decoder reads 8-bit "
            "(1/2/4-bit gray or palette) non-interlaced files")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError(f"{what}: PNG image data has {buf.size} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = buf.reshape(h, stride + 1)
    ftype, raw = rows[:, 0], rows[:, 1:]
    if (ftype > 4).any():
        raise ValueError(f"{what}: PNG filter type {int(ftype.max())}")
    if (ftype >= 3).any():
        px = _unfilter_diagonal(raw, ftype, bpp)
    else:
        px = _unfilter_rows(raw, ftype, bpp)
    if depth < 8:
        bits = np.unpackbits(px, axis=1)  # MSB first, as PNG packs them
        bits = bits.reshape(h, -1, depth)[:, :w]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits * weights).sum(-1, dtype=np.uint8)
        if ctype == 0:  # scale to 0..255 as PIL's "1"/"L;2"/"L;4" modes do
            px = px * np.uint8(255 // ((1 << depth) - 1))
    img = px.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{what}: palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[img[..., 0]]
    if ctype in (4, 6):
        img = img[..., :ch - 1]
    return np.ascontiguousarray(img)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, filter_type: int = 0) -> bytes:
    """uint8 [h, w] (gray) or [h, w, 3] (RGB) -> PNG bytes, every row
    filtered with ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype, bpp = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, bpp = 2, 3
    else:
        raise ValueError(f"encode_png takes [h, w] or [h, w, 3], got "
                         f"{img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type}")
    h, w = img.shape[:2]
    x = img.reshape(h, -1)
    rows = np.empty((h, 1 + x.shape[1]), np.uint8)
    rows[:, 0] = filter_type
    if filter_type == 0:
        rows[:, 1:] = x
    else:
        x = x.astype(np.int16)
        a = np.zeros_like(x)
        a[:, bpp:] = x[:, :-bpp]
        b = np.zeros_like(x)
        b[1:] = x[:-1]
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        rows[:, 1:] = (x - _predict(np.int16(filter_type), a, b, c)) & 255
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Loading with PIL's conversions


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of uint8 [..., 3]: ITU-R 601-2 in 16.16
    fixed point."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _load_with_pil(src, mode: str, what: str) -> np.ndarray:
    """``Image.open(src).convert(mode)``: ``src`` a path or a file
    object; ``what`` names it in errors."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{what}: not a PNG file, and PIL, which decodes other "
            "formats, is not installed") from None
    with Image.open(src) as im:
        return np.asarray(im.convert(mode), np.uint8)


def decode_rgb(data: bytes, what: str = "<bytes>") -> np.ndarray:
    """``Image.open(...).convert("RGB")`` of encoded image bytes as uint8
    [h, w, 3]: PNG in numpy, other formats through PIL."""
    if data[:8] != PNG_SIGNATURE:
        return _load_with_pil(io.BytesIO(data), "RGB", what)
    img = decode_png(data, what)
    return np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img


def load_rgb(path: str) -> np.ndarray:
    """``Image.open(path).convert("RGB")`` as uint8 [h, w, 3]."""
    with open(path, "rb") as f:
        return decode_rgb(f.read(), path)


def load_gray(path: str) -> np.ndarray:
    """``Image.open(path).convert("L")`` as uint8 [h, w]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        return _load_with_pil(path, "L", path)
    img = decode_png(data, path)
    return img[..., 0] if img.shape[2] == 1 else rgb_to_gray(img)


# ---------------------------------------------------------------------------
# Pillow's resamplers


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


@functools.lru_cache(maxsize=64)
def _bicubic_taps(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: per
    output pixel the source indices of its taps [out, k] and their int32
    weights at 22 fractional bits (0 past the window, index clamped)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        j = np.arange(xmax - xmin)
        w = _bicubic_filter((j + xmin - center + 0.5) * (1.0 / filterscale))
        total = 0.0
        for v in w:  # in Pillow's order: np.sum pairs terms from 8 on
            total += v
        if total != 0.0:
            w = w / total
        q = w * (1 << _PRECISION_BITS) + np.where(w >= 0, 0.5, -0.5)
        kk[xx, :j.size] = np.trunc(q).astype(np.int32)
        idx[xx] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    return idx, kk


def _resample_rows(img: np.ndarray, out_size: int) -> np.ndarray:
    """One Pillow pass along axis 0, in Pillow's int32 arithmetic; every
    tap gathers whole rows."""
    idx, kk = _bicubic_taps(img.shape[0], out_size)
    shape = (out_size,) + (1,) * (img.ndim - 1)
    acc = np.full((out_size,) + img.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    for t in range(idx.shape[1]):
        acc += np.take(img, idx[:, t], axis=0) * kk[:, t].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size: int) -> np.ndarray:
    """``Image.resize((size, size), Image.BICUBIC)`` of uint8 [h, w] or
    [h, w, c]: the horizontal pass (on the transposed image), then the
    vertical one."""
    horiz = _resample_rows(np.ascontiguousarray(img.swapaxes(0, 1)), size)
    return _resample_rows(np.ascontiguousarray(horiz.swapaxes(0, 1)), size)


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    step = in_size / out_size
    xo = step * 0.5
    idx = np.empty(out_size, np.int64)
    for x in range(out_size):
        idx[x] = min(int(xo), in_size - 1)
        xo += step
    return idx


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """``Image.resize((size, size), Image.NEAREST)`` of uint8 [h, w]."""
    return img[_nearest_indices(img.shape[0], size)][
        :, _nearest_indices(img.shape[1], size)]

"""The port's test-time input path (``aaclip_tpu_torch/data/``) against PIL
and the JAX package's, on the CPU, all bit for bit:

* PNG decode + PIL's bicubic resize at ``tests/test_native_image.py``'s
  shapes and sizes, on random and smooth images, every one of the five
  row filters (PIL's writer picks Sub, Up and Paeth; a test encoder writes
  each), and the L / LA / RGBA / P /
  gray-as-RGB / 1-bit / 4-bit-palette layouts through PIL's
  ``convert("RGB")``; masks through ``convert("L")`` and PIL's nearest;
* the PNG path without PIL; other formats through PIL, or an error naming
  the file without it;
* the synthetic dataset: the same pixels and metadata as JAX's for a seed;
* the registry, the metadata copy, ``get_test_datasets`` and
  ``BatchLoader``'s batches (uint8 and float images, masks, labels,
  ``n_valid``, file names) against JAX's.
"""

import dataclasses
import filecmp
import io
import os
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from aaclip_tpu.data import datasets as jdatasets
from aaclip_tpu.data import registry as jregistry
from aaclip_tpu.data.synthetic import make_synthetic_dataset as j_make
from aaclip_tpu_torch.data import datasets, image, registry, transforms
from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset

SHAPES = [(64, 64), (100, 83), (37, 41), (517, 300)]


def _save(arr_or_img, path, **kw):
    img = arr_or_img if isinstance(arr_or_img, Image.Image) \
        else Image.fromarray(arr_or_img)
    img.save(path, **kw)
    return path


def _pil_rgb(path, size):
    return np.asarray(Image.open(path).convert("RGB").resize(
        (size, size), Image.BICUBIC), np.uint8).transpose(2, 0, 1)


def _idat(data):
    return b"".join(b for k, b in image._chunks(data, "png") if k == b"IDAT")


def _filter_types(path):
    with open(path, "rb") as f:
        return _filter_types_of(f.read())


def _filter_types_of(data):
    idat = _idat(data)
    w, h, depth, ctype = np.frombuffer(data[16:26], ">u4,>u4,u1,u1")[0]
    stride = (int(w) * image._CHANNELS[int(ctype)] * int(depth) + 7) // 8
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert rows.shape[1] == stride + 1
    return set(rows[:, 0].tolist())


def _smooth(shape, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    sm = np.stack([(yy // 3 + xx // 5) % 256, (xx * 2) % 256,
                   (yy * xx // 97) % 256], -1)
    return (sm + rng.integers(0, 4, sm.shape)).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
def test_png_decode_resize_bit_exact(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    for name, a in (("random", rng.integers(0, 256, (*shape, 3),
                                            dtype=np.uint8)),
                    ("smooth", _smooth(shape, 1))):
        p = _save(a, str(tmp_path / f"{name}.png"))
        np.testing.assert_array_equal(image.load_rgb(p), a)
        for size in (70, 518, 33):
            np.testing.assert_array_equal(
                transforms.load_rgb_chw(p, size, uint8=True),
                _pil_rgb(p, size))


def _png_with_filters(a, ftypes):
    """PNG bytes of uint8 [h, w, c] (c 1 or 3) whose row y is filtered
    with ``ftypes[y % len(ftypes)]``. Filtering reads only unfiltered
    neighbours, so it is one vectorised step."""
    h, w, c = a.shape
    x = a.reshape(h, -1).astype(np.int16)
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, c:] = x[:-1, :-c]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    f = np.array([ftypes[y % len(ftypes)] for y in range(h)])
    filt = ((x - preds[f, np.arange(h)]) & 255).astype(np.uint8)
    rows = np.concatenate([f[:, None].astype(np.uint8), filt], axis=1)
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([8, {1: 0, 3: 2}[c],
                                                        0, 0, 0])
    return (image.PNG_SIGNATURE + image._chunk(b"IHDR", ihdr)
            + image._chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + image._chunk(b"IEND", b""))


@pytest.mark.parametrize("ftypes", [(0, 1, 2, 3, 4), (3,), (4,), (1, 2),
                                    (2, 4, 1, 3)])
@pytest.mark.parametrize("channels", [1, 3])
def test_every_png_filter_type_is_decoded(ftypes, channels):
    a = np.random.default_rng(len(ftypes)).integers(
        0, 256, (23, 31, channels), dtype=np.uint8)
    data = _png_with_filters(a, ftypes)
    np.testing.assert_array_equal(image.decode_png(data), a)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil.reshape(a.shape), a)


def test_pil_written_files_decode_as_pil_reads_them(tmp_path):
    seen = set()
    for i, shape in enumerate(SHAPES):
        for a in (_smooth(shape, i), _smooth(shape, i)[..., 0]):
            p = _save(a, str(tmp_path / f"s{i}_{a.ndim}.png"))
            seen |= _filter_types(p)
            want = np.asarray(Image.open(p))
            got = image.decode_png(open(p, "rb").read())
            np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert seen >= {1, 2, 4}  # Sub, Up, Paeth among PIL's adaptive rows


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "P", "gray-as-rgb",
                                  "1", "P16"])
def test_png_layouts_convert_as_pil(tmp_path, mode):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)
    if mode == "L":
        img = Image.fromarray(a[..., 0], "L")
    elif mode == "LA":
        img = Image.fromarray(a[..., :2], "LA")
    elif mode == "RGBA":
        rgba = np.concatenate(
            [a, rng.integers(0, 256, (48, 56, 1), dtype=np.uint8)], -1)
        img = Image.fromarray(rgba, "RGBA")
    elif mode == "P":
        img = Image.fromarray(a).convert("P", palette=Image.ADAPTIVE)
    elif mode == "P16":  # 16 colours: PIL writes 4-bit indices
        img = Image.fromarray(a).convert("P", palette=Image.ADAPTIVE,
                                         colors=16)
    elif mode == "1":
        img = Image.fromarray(a[..., 0] > 128)
    else:
        img = Image.fromarray(np.stack([a[..., 0]] * 3, -1))
    p = _save(img, str(tmp_path / f"v_{mode}.png"))
    np.testing.assert_array_equal(transforms.load_rgb_chw(p, 50, uint8=True),
                                  _pil_rgb(p, 50))
    np.testing.assert_array_equal(image.load_gray(p),
                                  np.asarray(Image.open(p).convert("L")))


def test_masks_nearest_bit_exact(tmp_path):
    rng = np.random.default_rng(3)
    for shape in [(64, 64), (700, 500), (33, 47)]:
        m = (rng.random(shape) > 0.7).astype(np.uint8) * 255
        p = _save(Image.fromarray(m, "L"), str(tmp_path / f"m{shape[0]}.png"))
        for size in (70, 518):
            want = np.asarray(Image.open(p).convert("L").resize(
                (size, size), Image.NEAREST))
            np.testing.assert_array_equal(
                image.resize_nearest(image.load_gray(p), size), want)
            np.testing.assert_array_equal(
                transforms.load_mask_binarized(p, size),
                (want != 0).astype(np.float32)[None])
    # an RGB-stored mask: PIL's L = (R*19595 + G*38470 + B*7471 + 0x8000)
    # >> 16
    m = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    p = _save(m, str(tmp_path / "mrgb.png"))
    np.testing.assert_array_equal(image.load_gray(p),
                                  np.asarray(Image.open(p).convert("L")))


def test_encoder_round_trips_through_pil(tmp_path):
    rng = np.random.default_rng(0)
    for a in (rng.integers(0, 256, (31, 45, 3), dtype=np.uint8),
              rng.integers(0, 256, (20, 9), dtype=np.uint8)):
        data = image.encode_png(a)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                      a)
        np.testing.assert_array_equal(
            image.decode_png(data).reshape(a.shape), a)
    with pytest.raises(ValueError, match="encode_png"):
        image.encode_png(np.zeros((2, 2, 4), np.uint8))


@pytest.mark.parametrize("filter_type", range(5))
def test_encoder_filter_types_round_trip(filter_type):
    rng = np.random.default_rng(filter_type)
    for a in (rng.integers(0, 256, (29, 37, 3), dtype=np.uint8),
              _smooth((40, 17), 2)[..., 1]):
        data = image.encode_png(a, filter_type)
        assert _filter_types_of(data) == {filter_type}
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                      a)
        np.testing.assert_array_equal(
            image.decode_png(data).reshape(a.shape), a)
        # the test's own filter, independent of the encoder
        want = _png_with_filters(a.reshape(*a.shape[:2], -1), (filter_type,))
        assert zlib.decompress(_idat(data)) == zlib.decompress(_idat(want))
    with pytest.raises(ValueError, match="filter type 5"):
        image.encode_png(a, 5)


def test_unsupported_and_corrupt_pngs_raise_naming_the_file(tmp_path):
    p = _save(Image.fromarray(np.zeros((4, 4), np.uint16) + 300),
              str(tmp_path / "deep.png"))
    with pytest.raises(ValueError, match="deep.png.*bit depth 16"):
        image.load_rgb(p)
    data = bytearray(image.encode_png(np.zeros((4, 4), np.uint8)))
    data[40] ^= 0xFF
    with pytest.raises(ValueError, match="corrupt"):
        image.decode_png(bytes(data), "x.png")


def test_png_path_needs_no_pil_and_jpeg_needs_pil(tmp_path, monkeypatch):
    a = np.random.default_rng(2).integers(0, 256, (30, 40, 3),
                                          dtype=np.uint8)
    png = _save(a, str(tmp_path / "a.png"))
    jpg = _save(a, str(tmp_path / "a.jpg"), quality=90)
    np.testing.assert_array_equal(
        transforms.load_rgb_chw(jpg, 33, uint8=True), _pil_rgb(jpg, 33))
    want_png = _pil_rgb(png, 33)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now fails
    np.testing.assert_array_equal(
        transforms.load_rgb_chw(png, 33, uint8=True), want_png)
    with pytest.raises(RuntimeError, match="a.jpg.*PIL"):
        transforms.load_rgb_chw(jpg, 33)


@pytest.mark.parametrize("hard", [False, True])
def test_synthetic_dataset_matches_jax(tmp_path, hard):
    port = make_synthetic_dataset(str(tmp_path / "port"), img_px=40, seed=3,
                                  hard=hard, n_normal=4, n_anomalous=3)
    jax = j_make(str(tmp_path / "jax"), img_px=40, seed=3, hard=hard,
                 n_normal=4, n_anomalous=3)
    for name in ("full-shot.jsonl", "2-shot.jsonl"):
        assert filecmp.cmp(os.path.join(port[1], "MVTec", name),
                           os.path.join(jax[1], "MVTec", name),
                           shallow=False)
    files = sorted(os.path.relpath(os.path.join(d, f), port[0])
                   for d, _, fs in os.walk(port[0]) for f in fs)
    assert len(files) == 2 * (4 + 3 + 3)
    for rel in files:
        want = np.asarray(Image.open(os.path.join(jax[0], rel)))
        got = image.decode_png(open(os.path.join(port[0], rel), "rb").read())
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_registry_and_metadata_are_faithful_copies(monkeypatch):
    assert set(registry.DATASETS) == set(jregistry.DATASETS)
    for name, spec in registry.DATASETS.items():
        j = jregistry.DATASETS[name]
        assert dataclasses.astuple(spec) == dataclasses.astuple(j)
        assert list(spec.real_names) == list(j.real_names)
    assert registry.DOMAINS == jregistry.DOMAINS
    assert registry.CLASS_NAMES == jregistry.CLASS_NAMES
    monkeypatch.setenv("AACLIP_DATA", "/srv/datasets")
    assert registry.DATASETS["MVTec"].data_path == \
        jregistry.DATASETS["MVTec"].data_path == "/srv/datasets/mvtec_ad"
    monkeypatch.delenv("AACLIP_METADATA", raising=False)
    ours, theirs = datasets.metadata_root(), jdatasets.metadata_root()
    assert ours != theirs
    for name in registry.DATASETS:
        path = datasets.metadata_path(name)
        assert filecmp.cmp(path, jdatasets.metadata_path(name),
                           shallow=False)
        assert [dataclasses.astuple(r) for r in datasets.read_jsonl(path)] \
            == [dataclasses.astuple(r)
                for r in jdatasets.read_jsonl(path)]
    assert datasets.metadata_path("MVTec", 4).endswith("MVTec/4-shot.jsonl")


def test_malformed_record_raises():
    with pytest.raises(ValueError, match="malformed metadata"):
        transforms._mask_for(None, 16, 1)
    assert not transforms._mask_for(None, 16, 0).any()


@pytest.mark.parametrize("uint8", [True, False])
def test_test_datasets_and_loader_batches_match_jax(tmp_path, monkeypatch,
                                                    uint8):
    data_root, meta_root = make_synthetic_dataset(str(tmp_path), img_px=48,
                                                  n_normal=3, n_anomalous=3)
    monkeypatch.setenv("AACLIP_DATA", data_root)
    monkeypatch.setenv("AACLIP_METADATA", meta_root)
    ours = datasets.get_test_datasets("MVTec", 70, uint8=uint8)
    theirs = jdatasets.get_test_datasets("MVTec", 70, uint8=uint8)
    assert list(ours) == list(theirs)
    assert [len(d) for d in ours.values()] == [6, 6] + [0] * 13
    for cls in ("bottle", "cable"):
        got = list(datasets.BatchLoader(ours[cls], 4, num_workers=2))
        want = list(jdatasets.BatchLoader(theirs[cls], 4, num_workers=2))
        assert [b["n_valid"] for b in got] == [b["n_valid"] for b in want] \
            == [4, 2]
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in ("image", "mask", "label"):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
            assert g["file_name"] == w["file_name"]
            assert g["class_name"] == w["class_name"]
        assert got[0]["image"].dtype == (np.uint8 if uint8 else np.float32)
        assert got[0]["mask"].shape == (4, 1, 70, 70)

"""The port's host libraries (``aaclip_tpu_torch/native/``) on the CPU.

Metrics (``fast_metrics.cc``):
* ``auroc_ap`` bit for bit against the JAX package's native kernel (a
  copy of the same source and C ABI), and within 1e-10 of the port's numpy
  path (the bar of ``tests/test_metrics.py``'s native-vs-numpy test), on
  random scores, heavy ties and ~2M pixels; NaN for a one-class input;
* ``label_components`` against ``scipy.ndimage.label`` and JAX's: the same
  partition up to a relabelling (in fact the same raster-order numbers);
* ``metrics_eval`` tables, AUPRO included, equal on both paths;
* two processes building the library at once both load a valid one;
  ``AACLIP_NO_NATIVE`` takes the numpy path.

Decode (``fast_image.cc``), bit for bit against the port's numpy decode
and resize (``data/image.py``) and JAX's native decode: PNG filters 0-4,
palette, gray, gray+alpha, RGBA, 1-bit, up- and down-scaling, masks; JPEG
against PIL where PIL is installed. Every decode case skips, naming why,
where the library does not build (no libjpeg/libpng headers).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from aaclip_tpu import native as jnative
from aaclip_tpu.native import image as jimage
from aaclip_tpu_torch import native
from aaclip_tpu_torch.data import image, transforms
from aaclip_tpu_torch.eval import metrics
from aaclip_tpu_torch.native import build
from aaclip_tpu_torch.native import image as nimage
from tests.test_torch_data import _png_with_filters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMPY_ATOL = 1e-10


@pytest.fixture
def needs_metrics():
    """Skips, naming why, where the metrics library does not build; the
    build is tried here, not when the module is imported."""
    if not native.native_available():
        pytest.skip(f"metrics library: "
                    f"{build.build_info().get('fast_metrics')}")


@pytest.fixture
def needs_image():
    """Skips, naming why, where the image library does not build (no
    libjpeg/libpng headers)."""
    if not nimage.image_native_available():
        pytest.skip(f"image library: {build.build_info().get('fast_image')}")


def _case(kind, seed=0):
    rng = np.random.default_rng(seed)
    n = {"random": 20000, "ties": 20000, "pixels_2m": 2_000_000}[kind]
    labels = rng.random(n) < 0.05
    scores = rng.random(n) + 0.3 * labels
    if kind == "ties":
        scores = np.round(scores * 16) / 16  # 22 distinct cuts
    return labels, scores


@pytest.mark.usefixtures("needs_metrics")
@pytest.mark.parametrize("kind", ["random", "ties", "pixels_2m"])
def test_auroc_ap_equals_jax_native_and_the_numpy_path(kind):
    labels, scores = _case(kind)
    got = native.auroc_ap(labels, scores)
    assert got == jnative.auroc_ap(labels, scores)  # bit for bit
    assert metrics.auroc_ap(labels, scores) == got
    np.testing.assert_allclose(got, metrics.auroc_ap_numpy(labels, scores),
                               atol=NUMPY_ATOL, rtol=0)


@pytest.mark.usefixtures("needs_metrics")
@pytest.mark.parametrize("positive", [False, True])
def test_a_one_class_input_is_nan(positive):
    labels = np.full(50, positive)
    scores = np.linspace(0, 1, 50)
    got = native.auroc_ap(labels, scores)
    assert np.isnan(got).all()
    assert np.isnan(jnative.auroc_ap(labels, scores)).all()
    # the numpy path leaves AP defined when every label is positive
    auc, ap = metrics.auroc_ap_numpy(labels, scores)
    assert np.isnan(auc) and np.isnan(ap) != positive
    with pytest.raises(ValueError, match="49 labels for 50 scores"):
        native.auroc_ap(labels[1:], scores)


def _same_partition(a, b):
    """Label images ``a`` and ``b`` are one partition up to relabelling."""
    assert np.array_equal(a > 0, b > 0)
    pairs = np.unique(np.stack([a[a > 0], b[b > 0]]), axis=1)
    return (len(np.unique(pairs[0])) == pairs.shape[1]
            == len(np.unique(pairs[1])))


@pytest.mark.usefixtures("needs_metrics")
@pytest.mark.parametrize("density", [0.1, 0.45, 0.7])
def test_label_components_equals_scipy_and_jax(density):
    from scipy import ndimage

    rng = np.random.default_rng(int(density * 100))
    mask = rng.random((61, 77)) < density
    mask[:, 40] = True  # one region across the rows
    lab, n = native.label_components(mask)
    want, wn = ndimage.label(mask)
    assert n == wn and _same_partition(lab, want)
    np.testing.assert_array_equal(lab, want)  # the same raster numbering
    jlab, jn = jnative.label_components(mask)
    assert jn == n
    np.testing.assert_array_equal(lab, jlab)
    assert lab.dtype == np.int32


@pytest.mark.usefixtures("needs_metrics")
def test_metrics_eval_tables_equal_on_both_paths(monkeypatch):
    from tests.test_torch_metrics import _case as table_case

    rng = np.random.default_rng(3)
    masks, labels, preds, image_scores = table_case(rng, "random", n=8,
                                                    h=40)
    got = metrics.metrics_eval(masks, labels, preds, image_scores, "c",
                               "Industrial", compute_aupro=True)
    monkeypatch.setattr(native, "auroc_ap", lambda *a: None)
    monkeypatch.setattr(native, "label_components", lambda *a: None)
    want = metrics.metrics_eval(masks, labels, preds, image_scores, "c",
                                "Industrial", compute_aupro=True)
    assert got == want and np.isfinite(got["pixel AUPRO"])


_BUILD_AND_CALL = textwrap.dedent("""
    import importlib.util, sys
    import numpy as np
    spec = importlib.util.spec_from_file_location("b", sys.argv[1])
    b = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(b)
    lib = b.load()
    assert lib is not None, b.build_info()
    import ctypes
    s = np.linspace(0, 1, 64)
    l = (np.arange(64) % 3 == 0).astype(np.uint8)
    a, p = ctypes.c_double(), ctypes.c_double()
    rc = lib.auroc_ap(s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                      l.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      64, ctypes.byref(a), ctypes.byref(p))
    print(rc, a.value, p.value)
""")


def test_two_processes_building_at_once_load_valid_libraries(tmp_path):
    """A fresh copy of the build script and source: both builds race to
    ``os.replace`` the same library name; each loads a complete one."""
    src = os.path.join(REPO, "aaclip_tpu_torch", "native")
    for name in ("build.py", "fast_metrics.cc", "fast_image.cc"):
        with open(os.path.join(src, name), "rb") as f, \
                open(tmp_path / name, "wb") as g:
            g.write(f.read())
    env = {k: v for k, v in os.environ.items() if k != "AACLIP_NO_NATIVE"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_CALL,
                               str(tmp_path / "build.py")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and outs[0][0].startswith("0 ")
    built = os.listdir(tmp_path / "_build")
    assert len([f for f in built if f.endswith(".so")]) == 1, built
    assert not [f for f in built if ".tmp-" in f], built


def test_no_native_takes_the_numpy_path(tmp_path):
    """``AACLIP_NO_NATIVE`` set: neither library loads, the metrics run in
    numpy and every image is decoded by ``data/image.py``."""
    png = str(tmp_path / "a.png")
    with open(png, "wb") as f:
        f.write(image.encode_png(np.zeros((9, 7, 3), np.uint8)))
    code = textwrap.dedent(f"""
        import numpy as np
        from aaclip_tpu_torch import native
        from aaclip_tpu_torch.data import transforms
        from aaclip_tpu_torch.eval import metrics
        from aaclip_tpu_torch.native import image
        assert native.metrics_path() == "numpy"
        assert not image.image_native_available()
        labels = np.arange(40) % 4 == 0
        scores = np.linspace(0, 1, 40)
        assert metrics.auroc_ap(labels, scores) == \\
            metrics.auroc_ap_numpy(labels, scores)
        transforms.load_rgb_chw({png!r}, 5, uint8=True)
        print(transforms.DECODE_COUNTS, native.build_info())
    """)
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "AACLIP_NO_NATIVE": "1"}).stdout
    assert "{'native': 0, 'fallback': 1}" in out
    assert "AACLIP_NO_NATIVE is set" in out


# ------------------------------------------------------------------ decode

def _numpy_chw(path, size):
    return transforms.to_uint8_chw(image.resize_bicubic(image.load_rgb(path),
                                                        size))


def _check_rgb(path, sizes=(16, 45)):
    """Native == numpy == JAX's native, at a down- and an up-scale."""
    for size in sizes:
        got = nimage.load_rgb_resize_chw(path, size)
        assert got is not None and got.shape == (3, size, size)
        np.testing.assert_array_equal(got, _numpy_chw(path, size))
        np.testing.assert_array_equal(got,
                                      jimage.load_rgb_resize_chw(path, size))


@pytest.mark.usefixtures("needs_image")
@pytest.mark.parametrize("ftypes", [(0,), (1,), (2,), (3,), (4,),
                                    (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("channels", [1, 3])
def test_png_filters_decode_as_numpy_and_jax(tmp_path, ftypes, channels):
    a = np.random.default_rng(sum(ftypes) + channels).integers(
        0, 256, (23, 31, channels), dtype=np.uint8)
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(_png_with_filters(a, ftypes))
    _check_rgb(p)


@pytest.mark.usefixtures("needs_image")
@pytest.mark.parametrize("mode", ["P", "L", "LA", "RGBA", "1", "P16"])
def test_png_layouts_decode_as_numpy_and_jax(tmp_path, mode):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (40, 52, 4), dtype=np.uint8)
    img = {"P": lambda: Image.fromarray(a[..., :3]).convert(
               "P", palette=Image.ADAPTIVE),
           "P16": lambda: Image.fromarray(a[..., :3]).convert(
               "P", palette=Image.ADAPTIVE, colors=16),
           "L": lambda: Image.fromarray(a[..., 0], "L"),
           "LA": lambda: Image.fromarray(a[..., :2], "LA"),
           "RGBA": lambda: Image.fromarray(a, "RGBA"),
           "1": lambda: Image.fromarray(a[..., 0] > 128)}[mode]()
    p = str(tmp_path / f"{mode}.png")
    img.save(p)
    _check_rgb(p)
    m = nimage.load_gray_resize_nearest(p, 30)
    np.testing.assert_array_equal(
        m, image.resize_nearest(image.load_gray(p), 30))
    np.testing.assert_array_equal(m, jimage.load_gray_resize_nearest(p, 30))


@pytest.mark.usefixtures("needs_image")
def test_masks_decode_as_numpy_and_jax(tmp_path):
    rng = np.random.default_rng(3)
    for k, m in enumerate(((rng.random((70, 50)) > 0.7) * 255,
                           rng.integers(0, 256, (33, 47, 3)))):
        p = str(tmp_path / f"m{k}.png")
        with open(p, "wb") as f:
            f.write(image.encode_png(m.astype(np.uint8), filter_type=2))
        for size in (20, 90):
            got = nimage.load_gray_resize_nearest(p, size)
            np.testing.assert_array_equal(
                got, image.resize_nearest(image.load_gray(p), size))
            np.testing.assert_array_equal(
                got, jimage.load_gray_resize_nearest(p, size))
            np.testing.assert_array_equal(
                transforms.load_mask_binarized(p, size),
                (got != 0).astype(np.float32)[None])


@pytest.mark.usefixtures("needs_image")
def test_jpeg_decodes_as_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    a = np.random.default_rng(4).integers(0, 256, (37, 53, 3),
                                          dtype=np.uint8)
    p = str(tmp_path / "a.jpg")
    Image.fromarray(a).save(p, quality=90)
    for size in (20, 70):
        want = np.asarray(Image.open(p).convert("RGB").resize(
            (size, size), Image.BICUBIC)).transpose(2, 0, 1)
        np.testing.assert_array_equal(nimage.load_rgb_resize_chw(p, size),
                                      want)


@pytest.mark.usefixtures("needs_image")
def test_a_layout_left_to_python_falls_back(tmp_path):
    """A 16-bit PNG: the library punts (rc != 0), ``load_rgb_chw`` takes
    ``data/image.py``, which names the file and its depth, and the
    fallback is counted."""
    import struct
    import zlib

    rows = b"".join(b"\x00" + bytes(8 * 3 * 2) for _ in range(4))
    ihdr = struct.pack(">IIBBBBB", 8, 4, 16, 2, 0, 0, 0)
    data = (image.PNG_SIGNATURE + image._chunk(b"IHDR", ihdr)
            + image._chunk(b"IDAT", zlib.compress(rows))
            + image._chunk(b"IEND", b""))
    p = str(tmp_path / "deep.png")
    with open(p, "wb") as f:
        f.write(data)
    assert nimage.load_rgb_resize_chw(p, 8) is None
    before = dict(transforms.DECODE_COUNTS)
    with pytest.raises(ValueError, match="deep.png.*bit depth 16"):
        transforms.load_rgb_chw(p, 8)
    assert transforms.DECODE_COUNTS["fallback"] == before["fallback"] + 1


def test_decode_counts_lose_no_update_across_threads(monkeypatch):
    """The loader's threads count their decodes into one dict under a
    lock: 16 threads (more than the cores) at a short switch interval
    count every one."""
    import threading

    monkeypatch.setattr(transforms, "DECODE_COUNTS",
                        {"native": 0, "fallback": 0})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [
            transforms._counted(None if k % 2 else 1, lambda: 0)
            for _ in range(2000)]) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert transforms.DECODE_COUNTS == {"native": 16000, "fallback": 16000}

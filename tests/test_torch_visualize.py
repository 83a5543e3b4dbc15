"""The port's ``test --visualize`` panels (aaclip_tpu_torch/eval/visualize.py)
against cv2 and against the JAX package's ``aaclip_tpu.eval.visualize``,
which writes through cv2, on the CPU:

* the JET table and the blend equal cv2's ``applyColorMap`` and JAX's
  ``apply_scoremap`` bit for bit;
* ``resize_linear`` equals ``cv2.resize`` (``INTER_LINEAR``) bit for bit
  on random uint8 images, up- and down-scaled, odd sizes, 1 and 3
  channels;
* whole panels of JAX's ``visualize`` on synthetic files: PNG names bit
  for bit (the decoded pixels of the two files); JPEG names (VisA's
  ``.JPG``) within 4 levels, since two libjpeg encoders may round apart;
* name collisions get numbered names and stale numbered panels go, as in
  JAX's;
* the evaluation CLI with ``--visualize`` beside JAX's: the same panel
  names, the image and mask rows bit for bit, the map rows within 3
  levels where the two maps (within atol 1e-4) round to neighbouring
  uint8 values, on at most 1% of the pixels.

cv2 imports here; where it does not, the tests that need it skip saying
so (the port itself never imports it).
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip(
    "cv2", reason="cv2 is the reference the panels are held to; the port "
                  "does not need it")

from aaclip_tpu.eval import visualize as jvis  # noqa: E402
from aaclip_tpu_torch.data.image import encode_png  # noqa: E402
from aaclip_tpu_torch.data.registry import DATASETS  # noqa: E402
from aaclip_tpu_torch.eval import visualize as vis  # noqa: E402

JPEG_LEVELS = 4


def test_jet_table_is_cv2s():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0, :]
    np.testing.assert_array_equal(vis.JET, lut)


def test_blend_is_jaxs_apply_scoremap():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (40, 30), dtype=np.uint8)
    want = jvis.apply_scoremap(img, cv2.cvtColor(gray, cv2.COLOR_GRAY2RGB))
    np.testing.assert_array_equal(vis.apply_scoremap(img, gray), want)


@pytest.mark.parametrize("shape,size", [
    ((64, 64, 3), (70, 70)), ((1024, 1024, 3), (518, 518)),
    ((33, 47, 3), (518, 518)), ((91, 77, 3), (37, 51)),
    ((300, 200, 1), (518, 518)), ((7, 9, 3), (20, 30)),
    ((5, 5, 3), (3, 3)), ((2, 2, 3), (33, 17)), ((517, 519, 3), (518, 518)),
])
def test_resize_linear_is_cv2_resize(shape, size):
    rng = np.random.default_rng(sum(shape) + sum(size))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if shape[2] == 1:
        img = img[..., 0]
    got = vis.resize_linear(img, size[1], size[0])
    np.testing.assert_array_equal(got, cv2.resize(img, (size[1], size[0])))


def _dataset(root, ext):
    """Three images of one class under the registry's path (``AACLIP_DATA``
    = ``root``), written as PNG or JPEG; their relative names."""
    name = "MVTec" if ext == ".png" else "VisA"
    base = DATASETS[name].data_path
    rng = np.random.default_rng(7)
    rels = []
    for i, (h, w) in enumerate([(64, 64), (91, 77), (300, 200)]):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(3 * xx) % 256, (2 * yy) % 256, (xx + yy) % 256], -1)
        img = np.clip(img + rng.integers(-30, 30, img.shape), 0, 255
                      ).astype(np.uint8)
        rel = f"bottle/test/{'good' if i else 'broken'}/{i:03d}{ext}"
        os.makedirs(os.path.dirname(os.path.join(base, rel)), exist_ok=True)
        path = os.path.join(base, rel)
        if ext == ".png":
            with open(path, "wb") as f:
                f.write(encode_png(img))
        else:
            from PIL import Image

            Image.fromarray(img).save(path, quality=90)
        rels.append(rel)
    return name, rels


def _panels(root, name):
    d = os.path.join(root, "visualization", name, "bottle")
    return {f: cv2.imread(os.path.join(d, f)) for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("ext", [".png", ".JPG"])
def test_panels_match_jaxs_visualize(tmp_path, monkeypatch, ext):
    monkeypatch.setenv("AACLIP_DATA", str(tmp_path / "data"))
    name, rels = _dataset(str(tmp_path / "data"), ext)
    rng = np.random.default_rng(3)
    preds = rng.random((3, 70, 70)).astype(np.float32) * 3 - 1
    masks = (rng.random((3, 1, 70, 70)) > 0.7).astype(np.float32)
    # JAX's module reads the registry of the JAX package (AACLIP_DATA too)
    jvis.visualize(masks, preds, rels, str(tmp_path / "jax"), name, "bottle")
    vis.visualize(masks, preds, rels, str(tmp_path / "port"), name, "bottle")
    want, got = _panels(tmp_path / "jax", name), _panels(tmp_path / "port",
                                                        name)
    assert sorted(got) == sorted(want) and len(got) == 3
    for f in want:
        assert got[f].shape == (210, 70, 3)
        if ext == ".png":
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            diff = np.abs(got[f].astype(int) - want[f]).max()
            assert diff <= JPEG_LEVELS, (f, diff)


def test_name_collisions_and_stale_panels(tmp_path, monkeypatch):
    """Two paths that flatten to one name get ``stem.1.ext``; a numbered
    panel of an earlier run goes when its name's first writer comes back,
    in both packages alike."""
    monkeypatch.setenv("AACLIP_DATA", str(tmp_path / "data"))
    name, rels = _dataset(str(tmp_path / "data"), ".png")
    base = DATASETS[name].data_path
    # "bottle/test/good_001.png" flattens as "bottle/test/good/001.png"
    twin = "bottle/test/good_001.png"
    with open(os.path.join(base, rels[1]), "rb") as f:
        data = f.read()
    with open(os.path.join(base, twin), "wb") as f:
        f.write(data)
    preds = np.random.default_rng(1).random((4, 70, 70))
    masks = np.zeros((4, 70, 70))
    for out, fn in (("jax", jvis.visualize), ("port", vis.visualize)):
        d = tmp_path / out / "visualization" / name / "bottle"
        os.makedirs(d)
        (d / "bottle_test_good_002.3.png").write_bytes(b"stale")
        fn(masks, preds, rels + [twin], str(tmp_path / out), name, "bottle")
    want, got = _panels(tmp_path / "jax", name), _panels(tmp_path / "port",
                                                        name)
    assert sorted(got) == sorted(want)
    assert "bottle_test_good_001.1.png" in got
    assert "bottle_test_good_002.3.png" not in got
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_eval_cli_visualize_beside_jax(tmp_path, monkeypatch):
    """``test --visualize`` in both packages on the synthetic set."""
    import torch

    from aaclip_tpu.core.config import get_config as jax_get_config
    from aaclip_tpu_torch import test as port_cli
    from aaclip_tpu_torch.core.config import AdapterConfig, get_config
    from aaclip_tpu_torch.core.params import (adapter_to_jax,
                                              init_image_adapter)
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.train import checkpoint as ckpt
    from tests.test_model_parity import _make_state_dict
    from tests.test_torch_eval_cli import COMMON

    root = str(tmp_path)
    data_root, meta_root = make_synthetic_dataset(root, img_px=64, hard=True)
    monkeypatch.setenv("AACLIP_DATA", data_root)
    monkeypatch.setenv("AACLIP_METADATA", meta_root)
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1,
                         text_adapt_until=1)
    clip = os.path.join(root, "tiny.pt")
    torch.save(_make_state_dict(jax_get_config("tiny-test", 56), seed=5),
               clip)
    save = {k: os.path.join(root, k) for k in ("jax", "port")}
    for d in save.values():
        ckpt.save_adapter_checkpoint(
            os.path.join(d, "image_adapter_1.npz"), 1,
            adapter_to_jax(init_image_adapter(cfg, acfg, seed=3,
                                              device="cpu")))
    import test as jax_cli

    argv = COMMON + ["--clip_checkpoint", clip, "--visualize"]
    jax_cli.main(argv + ["--save_path", save["jax"]])
    port_cli.main(argv + ["--save_path", save["port"]], device="cpu")
    for cls in ("bottle", "cable"):
        d = {k: os.path.join(save[k], "visualization", "MVTec", cls)
             for k in save}
        names = sorted(os.listdir(d["port"]))
        assert names == sorted(os.listdir(d["jax"])) and len(names) == 6
        for f in names:
            got, want = (cv2.imread(os.path.join(d[k], f)).astype(int)
                         for k in ("port", "jax"))
            np.testing.assert_array_equal(got[:140], want[:140], err_msg=f)
            diff = np.abs(got[140:] - want[140:])
            assert diff.max() <= 3 and (diff.max(-1) > 0).mean() <= 0.01, f

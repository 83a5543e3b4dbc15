"""The port's train-time host input path (``data/transforms.py``,
``data/datasets.py``) against the JAX package's, on the CPU.

Bars: all bit for bit.
* Colour jitter against JAX's ``color_jitter``, which is Pillow's
  ``ImageEnhance`` chain: 2000 seeded random images (flat, low-contrast
  and full-range) with the draws of seeded generators, and every triple of
  the factors 0.5, 1.0 and 1.5 on each image kind.
* ``joint_geometric_augment`` and ``preprocess_train`` (text and image
  stage, host and device-augment modes) from the same
  ``SeedSequence([seed, epoch, idx, stage])``, through both packages'
  ``TrainDataset``.
* ``BatchLoader``: each batch's files, pixels and ``n_valid`` over 3
  epochs, one host and each of two hosts.
"""

import itertools
import os

import numpy as np
import pytest
from PIL import Image

from aaclip_tpu.data import datasets as jdatasets
from aaclip_tpu.data import transforms as jT
from aaclip_tpu_torch.data import datasets
from aaclip_tpu_torch.data import transforms as T
from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset


class FixedDraws:
    """A generator stand-in that switches every enhancer on and returns
    the given factors in order."""

    def __init__(self, factors):
        self._factors = list(factors)

    def random(self):
        return 0.0

    def uniform(self, lo, hi):
        return self._factors.pop(0)


def _image(rng, kind):
    h, w = (int(v) for v in rng.integers(1, 33, 2))
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        img[:] = rng.integers(0, 256, 3, dtype=np.uint8)
    elif kind == "low":
        img = (img // 8 + rng.integers(0, 224)).astype(np.uint8)
    return img


def _jax_jitter(img, draws):
    return np.asarray(jT.color_jitter(Image.fromarray(img), draws))


def test_color_jitter_equals_pillow_for_seeded_draws():
    rng = np.random.default_rng(0)
    for i in range(2000):
        img = _image(rng, ("full", "low", "flat")[i % 3])
        got = T.color_jitter(img, np.random.default_rng(i))
        want = _jax_jitter(img, np.random.default_rng(i))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"image {i}")


@pytest.mark.parametrize("kind", ["full", "low", "flat"])
def test_color_jitter_equals_pillow_at_fixed_factors(kind):
    rng = np.random.default_rng(1)
    img = _image(rng, kind)
    for factors in itertools.product((0.5, 1.0, 1.5), repeat=3):
        got = T.jitter_chain(img, *factors)
        want = _jax_jitter(img, FixedDraws(factors))
        np.testing.assert_array_equal(got, want, err_msg=str(factors))


def test_jitter_factors_consume_jax_s_draws():
    for seed in range(50):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        T.jitter_factors(a)
        jT.color_jitter(Image.new("RGB", (2, 2)), b)
        assert a.random() == b.random()


def test_joint_geometric_augment_equals_jax():
    rng = np.random.default_rng(2)
    for i in range(40):
        H, W = (int(v) for v in rng.integers(8, 40, 2))
        img = rng.standard_normal((3, H, W)).astype(np.float32)
        mask = (rng.random((1, H, W)) > 0.7).astype(np.float32)
        got = T.joint_geometric_augment(img.copy(), mask.copy(),
                                        np.random.default_rng(i))
        want = jT.joint_geometric_augment(img.copy(), mask.copy(),
                                          np.random.default_rng(i))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    data_root, meta_root = make_synthetic_dataset(root, img_px=48,
                                                  n_normal=4, n_anomalous=3,
                                                  hard=True)
    env = {"AACLIP_DATA": data_root, "AACLIP_METADATA": meta_root}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    yield root
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.mark.parametrize("device_augment", [False, True])
def test_preprocess_train_equals_jax_through_the_datasets(synth,
                                                          device_augment):
    ours = datasets.get_train_datasets("MVTec", 70, -1, seed=5,
                                       device_augment=device_augment)
    theirs = jdatasets.get_train_datasets("MVTec", 70, -1, seed=5,
                                          device_augment=device_augment)
    for o, t in zip(ours, theirs):
        assert o.text_stage == t.text_stage and len(o) == len(t) == 14
        for idx in range(len(o)):
            for epoch in (0, 3):
                got, want = o.get(idx, epoch), t.get(idx, epoch)
                assert got["file_name"] == want["file_name"]
                assert got["label"] == want["label"]
                for k in ("image", "mask"):
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k])


def test_metadata_path_names_the_shot(synth):
    assert datasets.metadata_path("MVTec", 2) == \
        jdatasets.metadata_path("MVTec", 2)
    assert datasets.metadata_path("MVTec", -1).endswith("full-shot.jsonl")
    text_ds, _ = datasets.get_train_datasets("MVTec", 70, 2)
    assert [r.image_path for r in text_ds.records] == [
        r.image_path for r in jdatasets.get_train_datasets(
            "MVTec", 70, 2)[0].records]


def test_uint8_mode_needs_the_geometric_augment_deferred(synth):
    ds = datasets.get_train_datasets("MVTec", 70, -1)[1]
    r = ds.records[0]
    with pytest.raises(ValueError, match="geometric=False"):
        T.preprocess_train(os.path.join(ds.spec.data_path, r.image_path),
                           None, 70, 0, np.random.default_rng(0), False,
                           geometric=True, uint8=True)


@pytest.mark.parametrize("num_hosts", [1, 2])
def test_batch_loader_equals_jax_over_three_epochs(synth, num_hosts):
    ours = datasets.get_train_datasets("MVTec", 70, -1, seed=3)[1]
    theirs = jdatasets.get_train_datasets("MVTec", 70, -1, seed=3)[1]
    for host in range(num_hosts):
        kw = dict(shuffle=True, seed=9, num_workers=2, host_id=host,
                  num_hosts=num_hosts)
        a = datasets.BatchLoader(ours, 4, **kw)
        b = jdatasets.BatchLoader(theirs, 4, **kw)
        for _ in range(3):
            assert len(a) == len(b)
            got, want = list(a), list(b)
            assert len(got) == len(want) == len(a)
            for g, w in zip(got, want):
                assert g["file_name"] == w["file_name"]
                assert g["n_valid"] == w["n_valid"]
                np.testing.assert_array_equal(g["label"], w["label"])
                np.testing.assert_array_equal(g["image"], w["image"])
                np.testing.assert_array_equal(g["mask"], w["mask"])
        assert a.epoch == b.epoch == 3


def test_batch_loader_advances_its_epoch_when_left_early(synth):
    ds = datasets.get_train_datasets("MVTec", 70, -1)[0]
    loader = datasets.BatchLoader(ds, 4, shuffle=True, num_workers=1)
    first = next(iter(loader))["file_name"]
    assert loader.epoch == 1
    again = next(iter(loader))["file_name"]
    assert first != again

"""The port's anchor disk cache (``aaclip_tpu_torch/text/anchors.py::
encode_dataset_anchors_cached``) and ``utils/hashing.py`` on the CPU.

Bars: a cached result equals the uncached one bit for bit, and a hit runs
no text forward; the key separates the identity, the dataset and the
class list; a corrupt entry is rebuilt; an entry with another class count
is not trusted; ``sha256_file`` equals ``hashlib``'s digest. The engine's
use of the cache (a second engine reads the first's entries) is in
``tests/test_torch_serve.py``.
"""

import hashlib

import numpy as np
import torch

from aaclip_tpu_torch.text.anchors import (SENTENCES_PER_CLASS,
                                           encode_dataset_anchors,
                                           encode_dataset_anchors_cached)
from aaclip_tpu_torch.utils.hashing import sha256_file

CLASSES = ["bottle", "cable"]
D = 8


def _make_encode_fn():
    """A fixed token -> embedding map that counts its calls."""
    W = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (77, D)).astype(np.float32))
    calls = []

    def encode_fn(tokens):
        calls.append(tokens.shape[0])
        return tokens.float() @ W

    return encode_fn, calls


def test_cached_matches_uncached_and_skips_recompute(tmp_path):
    enc, calls = _make_encode_fn()
    want = encode_dataset_anchors(enc, "MVTec", CLASSES)
    assert calls == [len(CLASSES) * SENTENCES_PER_CLASS]
    got = encode_dataset_anchors_cached(enc, "MVTec", "id-a", str(tmp_path),
                                        CLASSES)
    assert len(calls) == 2  # a miss: computed and written
    again = encode_dataset_anchors_cached(enc, "MVTec", "id-a",
                                          str(tmp_path), CLASSES)
    assert len(calls) == 2  # a hit: no text forward
    for k in CLASSES:
        assert isinstance(got[k], np.ndarray) and got[k].shape == (D, 2)
        np.testing.assert_array_equal(got[k], want[k].numpy())
        np.testing.assert_array_equal(again[k], want[k].numpy())
    assert len(list(tmp_path.glob("anchors_*.npz"))) == 1
    assert not list(tmp_path.glob("*.tmp-*"))


def test_key_separates_identity_dataset_and_classes(tmp_path):
    enc, calls = _make_encode_fn()
    for dataset, identity, classes in [("MVTec", "id-a", CLASSES),
                                       ("MVTec", "id-b", CLASSES),
                                       ("MVTec", "id-a", ["bottle"]),
                                       ("VisA", "id-a", ["candle"])]:
        encode_dataset_anchors_cached(enc, dataset, identity, str(tmp_path),
                                      classes)
    assert len(calls) == 4  # four keys, four computes
    assert len(list(tmp_path.glob("anchors_*.npz"))) == 4
    encode_dataset_anchors_cached(enc, "VisA", "id-a", str(tmp_path),
                                  ["candle"])
    assert len(calls) == 4


def test_corrupt_entry_is_rebuilt(tmp_path):
    enc, calls = _make_encode_fn()
    first = encode_dataset_anchors_cached(enc, "MVTec", "id-a",
                                          str(tmp_path), CLASSES)
    (entry,) = tmp_path.glob("anchors_*.npz")
    entry.write_bytes(b"not an npz")
    rebuilt = encode_dataset_anchors_cached(enc, "MVTec", "id-a",
                                            str(tmp_path), CLASSES)
    assert len(calls) == 2
    for k in CLASSES:
        np.testing.assert_array_equal(rebuilt[k], first[k])
    encode_dataset_anchors_cached(enc, "MVTec", "id-a", str(tmp_path),
                                  CLASSES)
    assert len(calls) == 2  # the rebuilt entry is a hit again


def test_wrong_class_count_entry_is_not_trusted(tmp_path):
    enc, calls = _make_encode_fn()
    encode_dataset_anchors_cached(enc, "MVTec", "id-a", str(tmp_path),
                                  CLASSES)
    (entry,) = tmp_path.glob("anchors_*.npz")
    with np.load(entry) as z:
        arr = z["anchors"]
    np.savez(entry, anchors=arr[:1])
    got = encode_dataset_anchors_cached(enc, "MVTec", "id-a", str(tmp_path),
                                        CLASSES)
    assert len(calls) == 2
    np.testing.assert_array_equal(got["cable"], arr[1])


def test_sha256_file_equals_hashlib(tmp_path):
    data = np.random.default_rng(0).bytes(3 * (1 << 20) + 17)
    path = tmp_path / "blob.bin"
    path.write_bytes(data)
    assert sha256_file(str(path)) == hashlib.sha256(data).hexdigest()
    assert sha256_file(str(path), chunk=1000) == \
        hashlib.sha256(data).hexdigest()
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    assert sha256_file(str(empty)) == hashlib.sha256(b"").hexdigest()

"""Synthetic anomaly dataset: PNG images and masks with jsonl metadata in
the reference's on-disk layout, for the tests and for a smoke test of an
installation without any benchmark dataset (point ``AACLIP_DATA`` and
``AACLIP_METADATA`` at the returned roots and run ``python -m
aaclip_tpu_torch.test``). Draws, layout and metadata are the JAX
package's ``aaclip_tpu/data/synthetic.py``; the PNGs are written by
``data/image.py::encode_png``, so they decode to the same pixels."""

from __future__ import annotations

import collections
import concurrent.futures as cf
import json
import os

import numpy as np

from aaclip_tpu_torch.data.image import encode_png
from aaclip_tpu_torch.data.registry import DATASETS


def _write_png(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def make_synthetic_dataset(root: str, dataset_name: str = "MVTec",
                           class_names=None,
                           n_normal: int = 3, n_anomalous: int = 3,
                           img_px: int = 64, seed: int = 0,
                           hard: bool = False):
    """Write ``{root}/data/<spec.rel_path>/...`` images and
    ``{root}/metadata/<dataset>/{full,2}-shot.jsonl``; return (data_root,
    meta_root). The first two classes of the dataset unless
    ``class_names`` is given.

    Anomalous images get a bright square that their mask marks.
    ``hard=True`` makes the image-level task unsaturated: defect squares
    of variable size and an intensity overlapping the background texture,
    and a bright unmasked distractor on half the normal images."""
    spec = DATASETS[dataset_name]
    if class_names is None:
        class_names = tuple(spec.class_names[:2])
    data_root = os.path.join(root, "data")
    base = os.path.join(data_root, spec.rel_path)
    meta_root = os.path.join(root, "metadata")
    meta_dir = os.path.join(meta_root, dataset_name)
    os.makedirs(meta_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    records = []
    # draws in order; the PNG encoding (zlib releases the GIL) in threads,
    # at most two files per thread in flight
    workers = os.cpu_count() or 1
    with cf.ThreadPoolExecutor(workers) as pool:
        pending = collections.deque()

        def write(path, img):
            if len(pending) >= 2 * workers:
                pending.popleft().result()
            pending.append(pool.submit(_write_png, path, img))

        for cls in class_names:
            for kind, n, label in [("good", n_normal, 0),
                                   ("defect", n_anomalous, 1)]:
                for i in range(n):
                    rel = f"{cls}/test/{kind}/{i:03d}.png"
                    img = (rng.random((img_px, img_px, 3)) * 80
                           + 60).astype(np.uint8)
                    rec = {"image_path": rel, "label": label,
                           "class_name": cls}
                    if hard and not label and rng.random() < 0.5:
                        dy, dx = rng.integers(8, img_px - 24, size=2)
                        ds = int(rng.integers(6, 14))
                        img[dy:dy + ds, dx:dx + ds] = int(
                            rng.integers(150, 210))
                    if label:
                        if hard:
                            side = int(rng.integers(6, 21))
                            val = int(rng.integers(110, 231))
                        else:
                            side, val = 16, 230
                        y, x = rng.integers(8, img_px - 8 - side, size=2)
                        img[y:y + side, x:x + side] = val
                        mask = np.zeros((img_px, img_px), np.uint8)
                        mask[y:y + side, x:x + side] = 255
                        mrel = f"{cls}/ground_truth/{kind}/{i:03d}_mask.png"
                        write(os.path.join(base, mrel), mask)
                        rec["mask_path"] = mrel
                    write(os.path.join(base, rel), img)
                    records.append(rec)
        for w in pending:
            w.result()
    with open(os.path.join(meta_dir, "full-shot.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    with open(os.path.join(meta_dir, "2-shot.jsonl"), "w") as f:
        for cls in class_names:
            for r in [r for r in records if r["class_name"] == cls][:2]:
                f.write(json.dumps(r) + "\n")
    return data_root, meta_root

"""jsonl-backed test datasets and a threaded, prefetching batch loader.

Metadata follows the reference (dataset/metadata/*/full-shot.jsonl): one
JSON record per line with ``image_path``, ``label``, ``class_name`` and,
for anomalous samples, ``mask_path``. The port carries its own copy of the
benchmark metadata under ``data/metadata``; ``AACLIP_METADATA`` points
elsewhere.

The loader decodes in a thread pool while the card is busy; batch shapes
stay static: the final ragged batch is padded by repeating its last sample
and carries ``n_valid``.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from aaclip_tpu_torch.data import transforms as T
from aaclip_tpu_torch.data.registry import CLASS_NAMES, DATASETS, DatasetSpec


def metadata_root() -> str:
    """Directory holding <dataset>/{full,N}-shot.jsonl; ``AACLIP_METADATA``
    overrides it (read at each call)."""
    return os.environ.get(
        "AACLIP_METADATA",
        os.path.join(os.path.dirname(__file__), "metadata"),
    )


@dataclasses.dataclass
class Record:
    image_path: str
    label: int
    class_name: str
    mask_path: Optional[str] = None


def read_jsonl(path: str) -> List[Record]:
    records = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            m = json.loads(line)
            records.append(Record(
                image_path=m["image_path"],
                label=int(m["label"]),
                class_name=m["class_name"],
                mask_path=m.get("mask_path"),
            ))
    return records


def metadata_path(dataset_name: str, shot: int = -1) -> str:
    """``{shot}-shot.jsonl`` for a few-shot split, else ``full-shot.jsonl``
    (reference dataset/__init__.py:189-197)."""
    fname = f"{shot}-shot.jsonl" if shot > 0 else "full-shot.jsonl"
    return os.path.join(metadata_root(), dataset_name, fname)


@dataclasses.dataclass
class TestDataset:
    """Deterministic single-class evaluation view; ``uint8=True`` gives raw
    pixels for the normalisation folded into the patch embedding."""
    spec: DatasetSpec
    records: List[Record]
    img_size: int
    class_name: str
    uint8: bool = False

    def __len__(self) -> int:
        return len(self.records)

    def get(self, idx: int) -> dict:
        r = self.records[idx]
        img, mask = T.preprocess_test(
            os.path.join(self.spec.data_path, r.image_path),
            os.path.join(self.spec.data_path, r.mask_path)
            if r.mask_path else None,
            self.img_size, r.label, uint8=self.uint8,
        )
        return {"image": img, "mask": mask, "label": r.label,
                "class_name": r.class_name, "file_name": r.image_path}


def get_test_datasets(dataset_name: str, img_size: int,
                      uint8: bool = False) -> Dict[str, TestDataset]:
    """{class_name: dataset} in the registry's class order (reference
    dataset/__init__.py:203-216)."""
    spec = DATASETS[dataset_name]
    records = read_jsonl(metadata_path(dataset_name, -1))
    out = {}
    for class_name in CLASS_NAMES[dataset_name]:
        cls_records = [r for r in records if r.class_name == class_name]
        out[class_name] = TestDataset(spec, cls_records, img_size, class_name,
                                      uint8=uint8)
    return out


class BatchLoader:
    """Threaded prefetch loader producing dense numpy batches of a static
    ``batch_size`` in the dataset's order; the final ragged batch is
    padded by repeating its last sample and reports ``n_valid``."""

    def __init__(self, dataset, batch_size: int, *, num_workers: int = 4,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        # queue.Queue(maxsize=0) would be unbounded
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _assemble(self, samples: List[dict], n_valid: int) -> dict:
        while len(samples) < self.batch_size:
            samples.append(samples[-1])
        return {
            "image": np.stack([s["image"] for s in samples]),
            "mask": np.stack([s["mask"] for s in samples]),
            "label": np.array([s["label"] for s in samples], np.int32),
            "class_name": [s["class_name"] for s in samples],
            "file_name": [s["file_name"] for s in samples],
            "n_valid": n_valid,
        }

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        batches = [range(i, min(i + self.batch_size, n))
                   for i in range(0, n, self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # a bounded put that gives up once the consumer has left
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.get, b))
                        if not _put(self._assemble(samples, len(b))):
                            return
                _put(None)
            except BaseException as e:  # re-raised in the consumer
                _put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()

"""jsonl-backed datasets and a threaded, prefetching batch loader.

Metadata follows the reference (dataset/metadata/*/full-shot.jsonl): one
JSON record per line with ``image_path``, ``label``, ``class_name`` and,
for anomalous samples, ``mask_path``. The port carries its own copy of the
benchmark metadata under ``data/metadata``; ``AACLIP_METADATA`` points
elsewhere.

The loader decodes (and, for training, augments) in a thread pool while
the card is busy; batch shapes stay static: the final ragged batch is
padded by repeating its last sample and carries ``n_valid``. Training
epochs are shuffled from ``SeedSequence([seed, epoch])`` and may be
sharded over hosts, as the JAX package's loader does.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from aaclip_tpu_torch.data import transforms as T
from aaclip_tpu_torch.data.registry import CLASS_NAMES, DATASETS, DatasetSpec
from aaclip_tpu_torch.parallel.sharding import pad_batch_to_devices


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
class TrainDataset:
    """Randomly augmented training view (text or image stage): sample
    ``idx`` of ``epoch`` draws from ``SeedSequence([seed, epoch, idx,
    text_stage])``. ``device_augment=True`` leaves the geometric augment
    to the card and emits uint8 images and masks (the colour jitter and
    the resize still run here)."""
    spec: DatasetSpec
    records: List[Record]
    img_size: int
    text_stage: bool
    seed: int = 111
    device_augment: bool = False

    def __len__(self) -> int:
        return len(self.records)

    def get(self, idx: int, epoch: int) -> dict:
        r = self.records[idx]
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, epoch, idx, int(self.text_stage)]))
        img, mask = T.preprocess_train(
            os.path.join(self.spec.data_path, r.image_path),
            os.path.join(self.spec.data_path, r.mask_path)
            if r.mask_path else None,
            self.img_size, r.label, rng, self.text_stage,
            geometric=not self.device_augment, uint8=self.device_augment)
        return {"image": img, "mask": mask, "label": r.label,
                "class_name": r.class_name, "file_name": r.image_path}


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

    def get(self, idx: int, epoch: int = 0) -> dict:
        r = self.records[idx]
        img, mask = T.preprocess_test(
            os.path.join(self.spec.data_path, r.image_path),
            os.path.join(self.spec.data_path, r.mask_path)
            if r.mask_path else None,
            self.img_size, r.label, uint8=self.uint8,
        )
        return {"image": img, "mask": mask, "label": r.label,
                "class_name": r.class_name, "file_name": r.image_path}


def get_train_datasets(dataset_name: str, img_size: int, shot: int = -1,
                       seed: int = 111, device_augment: bool = False):
    """(text-stage dataset, image-stage dataset) over the same metadata
    (reference dataset/__init__.py:188-202)."""
    spec = DATASETS[dataset_name]
    records = read_jsonl(metadata_path(dataset_name, shot))
    return tuple(TrainDataset(spec, records, img_size, text_stage=stage,
                              seed=seed, device_augment=device_augment)
                 for stage in (True, False))


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
    ``batch_size``; the final ragged batch is padded by repeating its last
    sample and reports ``n_valid``. ``shuffle`` permutes each epoch from
    ``SeedSequence([seed, epoch])``; ``host_id`` / ``num_hosts`` shard the
    indices. ``epoch`` advances after each pass, also one left early.

    ``deal_batches=True`` deals each batch instead (the port's CLIs under
    ``torchrun``, where ``batch_size`` is the global batch): the epoch's
    batches are one host's, each is padded to a multiple of ``num_hosts``
    with invalid rows (``parallel/sharding.py::pad_batch_to_devices``,
    JAX's padding), and this host takes rows ``host_id``, ``host_id +
    num_hosts``, ... of it (``sharding.shard_rows``'s), ``ceil(batch_size
    / num_hosts)`` a batch. It loads only its valid ones (one padding row
    where it has none) and repeats the last, so the hosts together decode
    each sample once."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 111, num_workers: int = 4, prefetch: int = 2,
                 host_id: int = 0, num_hosts: int = 1,
                 deal_batches: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.deal_batches = deal_batches
        # the rows a batch of this host holds
        self.rows = -(-batch_size // num_hosts) if deal_batches \
            else batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        # queue.Queue(maxsize=0) would be unbounded
        self.prefetch = max(1, prefetch)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.epoch = 0

    def indices(self) -> Tuple[np.ndarray, int]:
        """(this host's indices for the current epoch, how many of them are
        real). Every host gets ceil(n / num_hosts) indices, so all run the
        same number of batches; the at most one wrap-around pad index sits
        at the tail, outside the final batch's ``n_valid``."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch]))
            rng.shuffle(idx)
        if self.deal_batches:
            return idx, idx.size
        mine = idx[self.host_id::self.num_hosts]
        n_real = mine.size
        if self.num_hosts > 1:
            per = -(-idx.size // self.num_hosts)
            if mine.size < per:
                mine = np.concatenate([mine, idx[:per - mine.size]])
        return mine, n_real

    def batches(self) -> List[Tuple[np.ndarray, int]]:
        """The current epoch's (indices, n_valid) per batch: unpadded, or
        under ``deal_batches`` this host's rows of each padded batch."""
        indices, n_real = self.indices()
        B = self.batch_size
        out = [(indices[i:i + B], max(0, min(B, n_real - i)))
               for i in range(0, len(indices), B)]
        if not self.deal_batches:
            return out
        r, k = self.host_id, self.num_hosts
        dealt = []
        for b, n_valid in out:
            b = np.concatenate([b, np.repeat(b[-1:], B - len(b))])
            valid = (np.arange(B) < n_valid).astype(np.float32)
            (b,), valid = pad_batch_to_devices([b], valid, k)
            n = int(valid[r::k].sum())
            # rows past the valid ones are loaded once: _assemble repeats
            dealt.append((b[r::k][:max(n, 1)], n))
        return dealt

    def __len__(self) -> int:
        return -(-self.indices()[0].size // self.batch_size)

    def _assemble(self, samples: List[dict], n_valid: int) -> dict:
        while len(samples) < self.rows:
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
        batches = self.batches()
        epoch = self.epoch
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
                    for b, n_valid in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(
                            lambda i: self.dataset.get(int(i), epoch), b))
                        if not _put(self._assemble(samples, n_valid)):
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
            # in the finally: a consumer that leaves early must still
            # advance the epoch, or the next pass replays the same shuffle
            # and augment streams
            self.epoch += 1

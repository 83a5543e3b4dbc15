"""The training set held on the card (the JAX package's
``aaclip_tpu/data/device_cache.py``, ``--device_augment --cache_device``).

Industrial anomaly-detection training sets are small (MVTec's full shot
is ~3.6k images, ~4 GB as uint8 at 518 px), so the raw set is uploaded
once and every batch is assembled on the card: gathered by index,
colour-jittered (image stage), geometrically augmented (the packed uint8
gather) and normalised. Each step then sends the card only a [B] index
vector.

* The cached images are the resized uint8 pixels before the jitter
  (``preprocess_train`` with ``text_stage=True, uint8=True``) and uint8
  {0, 1} masks; the card jitters after the resize, where the host path
  jitters before it (the JAX package's order too).
* The epoch plan is ``BatchLoader``'s: its permutation from
  ``SeedSequence([seed, epoch])`` and its final-batch padding (the last
  sample repeated, ``valid`` marking the real ones).
* Each batch's draws come from ``ops/augment.py::augment_generator(
  aug_seed, stage, epoch, it)``, the host path's device-augment stream.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator, Tuple

import numpy as np
import torch

from aaclip_tpu_torch.data import transforms as T
from aaclip_tpu_torch.data.datasets import BatchLoader, TrainDataset
from aaclip_tpu_torch.ops.augment import (augment_generator, color_jitter,
                                          geometric_augment_u8,
                                          geometric_params, normalize_valid)


def cache_nbytes(n: int, img_size: int) -> int:
    """Device bytes of a cached set: uint8 image and mask, two int32
    labels per sample."""
    return n * (3 + 1) * img_size * img_size + n * 8


class DeviceCacheLoader:
    """Iterator of assembled batches on ``device``: ``(images float32
    [B, 3, H, W], mask float32 [B, H, W], label, class_idx, valid)``, in
    place of ``BatchLoader`` and the host-to-card copy and augment.
    ``epoch`` advances after each pass and drives the permutation and the
    draws."""

    def __init__(self, dataset: TrainDataset, cls_to_idx: dict,
                 batch_size: int, seed: int, *, text_stage: bool,
                 aug_seed: int, device, num_workers: int = 4):
        n = len(dataset)
        if n == 0:
            raise ValueError("cannot cache an empty dataset")
        spec, size = dataset.spec, dataset.img_size

        def load(r):
            return T.preprocess_train(
                os.path.join(spec.data_path, r.image_path),
                os.path.join(spec.data_path, r.mask_path)
                if r.mask_path else None,
                size, r.label, None, text_stage=True, geometric=False,
                uint8=True)

        with cf.ThreadPoolExecutor(max(1, num_workers)) as pool:
            samples = list(pool.map(load, dataset.records))
        dev = torch.device(device)
        # one upload of each: the only copy of the whole set in the run
        self._imgs = torch.from_numpy(
            np.stack([s[0] for s in samples])).to(dev)
        self._masks = torch.from_numpy(
            np.stack([s[1][0] for s in samples])).to(dev)
        self._labels = torch.tensor([r.label for r in dataset.records],
                                    dtype=torch.int32, device=dev)
        self._cidx = torch.tensor([cls_to_idx[r.class_name]
                                   for r in dataset.records],
                                  dtype=torch.int32, device=dev)
        self._plan = BatchLoader(dataset, batch_size, shuffle=True,
                                 seed=seed)
        self.batch_size = batch_size
        self.text_stage = text_stage
        self.aug_seed = aug_seed
        self.device = dev

    @property
    def epoch(self) -> int:
        return self._plan.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self._plan.epoch = value

    def __len__(self) -> int:
        return len(self._plan)

    def assemble(self, idx: np.ndarray, gen: torch.Generator
                 ) -> Tuple[torch.Tensor, ...]:
        """One batch from cache rows ``idx``: (images, mask, label,
        class_idx)."""
        i = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
        im, mk = self._imgs[i], self._masks[i]
        if not self.text_stage:
            im = color_jitter(gen, im)
        B, _, H, W = im.shape
        im, mk, valid = geometric_augment_u8(im, mk,
                                             geometric_params(gen, B, H, W))
        return (normalize_valid(im, valid), mk.float() * valid.float(),
                self._labels[i], self._cidx[i])

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        stage = 1 if self.text_stage else 2
        epoch = self.epoch
        B = self.batch_size
        try:
            for it, (b, n_valid) in enumerate(self._plan.batches()):
                b = np.concatenate([b, np.repeat(b[-1:], B - b.size)])
                gen = augment_generator(self.aug_seed, stage, epoch, it,
                                        self.device)
                valid = (torch.arange(B, device=self.device)
                         < n_valid).float()
                yield (*self.assemble(b, gen), valid)
        finally:
            self.epoch = epoch + 1

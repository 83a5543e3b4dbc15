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
* ``make_fused_step`` (``--fused_assemble``, the JAX package's fold of
  batch k+1's assembly into step k's program) assembles the next batch on
  a second CUDA stream while the step runs; each batch keeps its own
  generator, so the numbers are the unfused loop's.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Callable, Iterator, List, Tuple

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

    def epoch_plan(self) -> List[Tuple[np.ndarray, torch.Generator,
                                       torch.Tensor]]:
        """The current epoch's per-step inputs, ``[(idx [B], generator,
        valid [B]), ...]``: the shuffled indices padded by the last one,
        each batch's own draws and its validity mask, as ``__iter__``
        assembles them; ``make_fused_step``'s loop reads batch k+1's
        during step k."""
        stage = 1 if self.text_stage else 2
        B = self.batch_size
        plan = []
        for it, (b, n_valid) in enumerate(self._plan.batches()):
            b = np.concatenate([b, np.repeat(b[-1:], B - b.size)])
            gen = augment_generator(self.aug_seed, stage, self.epoch, it,
                                    self.device)
            valid = (torch.arange(B, device=self.device) < n_valid).float()
            plan.append((b, gen, valid))
        return plan

    def advance_epoch(self) -> None:
        self.epoch += 1

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        try:
            for b, gen, valid in self.epoch_plan():
                yield (*self.assemble(b, gen), valid)
        finally:
            self.advance_epoch()

    def make_fused_step(self, step: Callable) -> Callable:
        """``fused(adapter, images, mask, label, class_idx, valid, next_idx,
        next_gen) -> (loss, next_batch)``: ``step`` (``make_stage2_step``'s)
        on one assembled batch, and the assembly of the next,
        ``self.assemble(next_idx, next_gen)``.

        On the card the assembly runs on a second CUDA stream, so its
        gathers and augment fill the gaps of the step's many small kernels
        (the JAX package puts both in one XLA program for the same
        reason): the side stream first waits for the work queued before
        the step (an event on the current stream), takes the assembly, and
        the current stream then waits for it before anything queued after
        the step, such as the next step, can read the batch; the batch's
        buffers are recorded on the current stream, so the allocator does
        not hand them out again while a step may still read them. On the
        CPU the two run in sequence. Each batch draws from its own
        generator, so the numbers are those of the unfused loop."""
        dev = self.device
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def fused(adapter, images, mask, label, class_idx, valid, next_idx,
                  next_gen):
            if side is None:
                loss = step(adapter, images, mask, label, class_idx, valid)
                return loss, self.assemble(next_idx, next_gen)
            current = torch.cuda.current_stream(dev)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                nbatch = self.assemble(next_idx, next_gen)
            loss = step(adapter, images, mask, label, class_idx, valid)
            current.wait_stream(side)
            for t in nbatch:
                t.record_stream(current)
            return loss, nbatch

        return fused

"""Optimizers and learning-rate schedules of the two training stages, as
the JAX package sets them (``aaclip_tpu/train/optim.py``, after the
reference's train.py):

* Adam with betas (0.5, 0.999), eps 1e-8, no weight decay;
* stage 2 (the image adapters) steps MultiStepLR(milestones (16000,
  32000), gamma 0.5) once per update, so update n (from 0) runs at
  ``lr * gamma ** (milestones <= n)``, as optax's
  ``piecewise_constant_schedule`` gives it; stage 1 keeps its LR.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

BETAS = (0.5, 0.999)
EPS = 1e-8


def make_text_optimizer(params: Iterable[torch.Tensor],
                        lr: float = 1e-5) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS)


def make_image_optimizer(params: Iterable[torch.Tensor], lr: float = 5e-4,
                         milestones: Sequence[int] = (16000, 32000),
                         gamma: float = 0.5):
    """``(Adam, MultiStepLR)`` for the image adapters; call the
    scheduler's ``step()`` once after each optimizer step (the stage-2
    step does)."""
    opt = torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, milestones=list(milestones), gamma=gamma)
    return opt, sched

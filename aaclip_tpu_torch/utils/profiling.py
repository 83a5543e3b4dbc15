"""Throughput counter of the evaluation CLI."""

from __future__ import annotations

import time
from typing import Optional


class StepTimer:
    """Items per second across ticks, the first tick's items and the time
    before it excluded (its window holds the warm-up)."""

    def __init__(self):
        self._count = 0
        self._items = 0
        self._start: Optional[float] = None
        self._last_tick: Optional[float] = None

    def tick(self, n_items: int = 1) -> None:
        now = time.perf_counter()
        self._count += 1
        if self._count == 1:
            self._start = now
        else:
            self._items += n_items
        self._last_tick = now

    def rate(self) -> float:
        if self._count < 2 or self._start is None:
            return 0.0
        elapsed = self._last_tick - self._start
        return self._items / elapsed if elapsed > 0 else 0.0

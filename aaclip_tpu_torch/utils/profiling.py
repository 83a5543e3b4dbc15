"""Throughput counters and the host-loop profile of the CLIs."""

from __future__ import annotations

import contextlib
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

    def stop(self) -> None:
        """Close the window now: ticks come at dispatch time, so after the
        queued work has been waited for (the losses drained), the window
        must reach this point for the rate to be the wall's."""
        if self._count:
            self._last_tick = time.perf_counter()

    def rate(self) -> float:
        if self._count < 2 or self._start is None:
            return 0.0
        elapsed = self._last_tick - self._start
        return self._items / elapsed if elapsed > 0 else 0.0


class HostLoopProfiler:
    """Where a training CLI's host loop spends its wall time, by phase:

        prof = HostLoopProfiler()
        for batch in prof.wrap(loader):       # 'loader_wait'
            with prof.phase("h2d"): ...
            with prof.phase("step_dispatch"): ...
        prof.report(logger)

    Wall times (perf_counter). The card runs asynchronously, so
    'step_dispatch' is the cost of queueing the step; the card's time
    shows where the host first waits for a result ('loss_fetch', or a
    copy that must wait for the queue). The first batch of each
    ``wrap`` (the warm-up) is left out."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._acc: dict = {}
        self._skip = True

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if not self._skip:
                e = self._acc.setdefault(name, [0, 0.0])
                e[0] += 1
                e[1] += time.perf_counter() - t0

    def wrap(self, iterable):
        if not self.enabled:
            yield from iterable
            return
        it = iter(iterable)
        self._skip = True
        while True:
            with self.phase("loader_wait"):
                try:
                    batch = next(it)
                except StopIteration:
                    return
            yield batch
            self._skip = False

    def report(self, log=None) -> str:
        if not self.enabled or not self._acc:
            return ""
        total = sum(s for _, s in self._acc.values())
        lines = ["host-loop phase decomposition (per profiled step):"]
        n_steps = max((n for n, _ in self._acc.values()), default=0)
        for name, (n, s) in sorted(self._acc.items(),
                                   key=lambda kv: -kv[1][1]):
            lines.append(
                f"  {name:<16} {s / max(n, 1) * 1e3:8.2f} ms/step  "
                f"({100 * s / total:5.1f}% of accounted, n={n})")
        lines.append(f"  accounted wall: {total:.2f} s over ~{n_steps} "
                     "steps (unaccounted gaps = python overhead)")
        text = "\n".join(lines)
        if log is not None:
            log.info("%s", text)
        return text


class ThrottledLossDrain:
    """Per-step loss scalars kept as device tensors; the host waits for
    the card only every ``fetch_every`` appends, on the loss from
    ``fetch_every`` steps back, which bounds the batches in flight to
    about twice that without idling the card between waits. ``drain``
    copies the rest in one transfer and returns every value in step
    order."""

    def __init__(self, fetch_every: int = 8):
        self.fetch_every = max(1, int(fetch_every))
        self._dev: list = []

    def append(self, loss) -> None:
        self._dev.append(loss)
        k = self.fetch_every
        if len(self._dev) > k and len(self._dev) % k == 0:
            float(self._dev[len(self._dev) - 1 - k])

    def drain(self) -> list:
        import torch

        vals = (torch.stack([v.reshape(()) for v in self._dev]).cpu()
                .tolist() if self._dev else [])
        self._dev = []
        return [float(v) for v in vals]

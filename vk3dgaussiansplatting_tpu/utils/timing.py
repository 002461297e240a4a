"""Per-pass timing harness replicating the reference benchmark protocol.

The reference's `RECORD_GPU_TIMES` mode (Renderer.h:35-36, Renderer.cpp:
458-510) writes GPU timestamps around each logical pass, skips 1000 warmup
frames, then reports a 1000-frame running average via a popup.  The
equivalent here times jitted pass functions with `block_until_ready` fences
and the same warmup/average protocol (configurable).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax

# Reference protocol constants (Renderer.h:142-143).
WAIT_ELAPSED_WARMUP_FRAMES_FOR_AVG = 1000
NUM_AVG_FRAMES = 1000


@dataclasses.dataclass
class RunningAverage:
    """The reference's running-mean update (Renderer.cpp:477-487)."""

    warmup_frames: int = WAIT_ELAPSED_WARMUP_FRAMES_FOR_AVG
    avg_frames: int = NUM_AVG_FRAMES
    _seen: int = 0
    _count: int = 0
    _mean: float = 0.0

    def add(self, value: float) -> None:
        self._seen += 1
        if self._seen <= self.warmup_frames:
            return
        if self._count < self.avg_frames:
            self._count += 1
            self._mean += (value - self._mean) / self._count

    @property
    def done(self) -> bool:
        return self._count >= self.avg_frames

    @property
    def mean(self) -> float:
        return self._mean


def time_fn(
    fn: Callable[[], object],
    *,
    warmup: int = 3,
    iters: int = 20,
) -> float:
    """Median wall-clock seconds of `fn` with device-completion fences."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def time_fn_avg_protocol(
    fn: Callable[[], object],
    *,
    warmup: int = WAIT_ELAPSED_WARMUP_FRAMES_FOR_AVG,
    avg: int = NUM_AVG_FRAMES,
) -> float:
    """Exact reference protocol: N warmup frames then N-frame running mean.
    Expensive — used for headline numbers only."""
    acc = RunningAverage(warmup_frames=warmup, avg_frames=avg)
    while not acc.done:
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        acc.add(time.perf_counter() - t0)
    return acc.mean

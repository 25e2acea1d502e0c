"""Profiling hooks (counterpart of ``entropy_coders_tpu/utils/profiling.py``):
``trace`` captures a ``torch.profiler`` trace where the JAX package captures
a ``jax.profiler`` one; ``timed`` wall-clocks a block into a
``TimedResult``, as the JAX package's does."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch

__all__ = ["TimedResult", "timed", "trace"]


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace of the enclosed block::

        with utils.trace("traces/ect") as prof:
            frame.decompress(comp)
        prof.key_averages()

    CPU activity always, and CUDA activity (every kernel and copy on the
    card's timeline) where CUDA is available; the card's queued work is
    waited for before the block ends. The trace is written into
    ``log_dir`` as ``<worker>.<time>.pt.trace.json`` when the block
    exits; open it with TensorBoard's profiler plugin or Perfetto. Yields
    the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


@dataclass
class TimedResult:
    name: str
    seconds: float
    nbytes: int | None = None

    @property
    def throughput(self) -> float | None:
        if self.nbytes is None or self.seconds <= 0:
            return None
        return self.nbytes / self.seconds

    def __str__(self) -> str:
        s = f"{self.name}: {self.seconds * 1e3:.2f} ms"
        if self.throughput is not None:
            s += f" ({self.throughput / 1e6:.1f} MB/s)"
        return s


@contextlib.contextmanager
def timed(name: str, nbytes: int | None = None, results: list | None = None):
    """Wall-clock a block; appends a ``TimedResult`` to ``results`` if
    given. The card's queued work is not waited for: synchronise inside
    the block to time it."""
    t0 = time.perf_counter()
    r = TimedResult(name, 0.0, nbytes)
    try:
        yield r
    finally:
        r.seconds = time.perf_counter() - t0
        if results is not None:
            results.append(r)

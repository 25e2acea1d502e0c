"""Profiling hooks (counterpart of ``entropy_coders_tpu/utils/profiling.py``):
``trace`` captures a ``torch.profiler`` trace where the JAX package captures
a ``jax.profiler`` one; ``timed`` wall-clocks a block into a
``TimedResult``, as the JAX package's does.

``counters`` holds the port's own counts, always on (a dict add a site a
call, no switch): ``calls.compress`` and ``calls.decompress``, the frame
calls made (every decode of a parsed frame counts as a decompress), and
``host_bytes.<op>.<site>``, the bytes of the fresh host buffers those calls
made at each site whose buffer grows with the input (``frame``: the
decompressed ``bytes``, an unaligned range's staging buffer, the sections,
the frame's join, the RAW and RLE escapes, the host copies of a
shared-stream share). A buffer that is reused, or given by the caller
(``out=``), counts 0; so does the pinned staging of the copies, which
torch's caching host allocator keeps between calls.
``decompress.in_place`` counts the decompresses decoded straight into the
``bytes`` they return. Frames with per-block crc32s count the raw bytes
checksummed (``crc.compress``, ``crc.decompress``); bit-packed frames count
each per-lane block's lane-size table by its kind,
``size_table.<op>.coded`` (k=2-coded) or ``size_table.<op>.raw`` (stored as
it is). Take ``dict(counters)`` before and after a call to
read what it made."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch

__all__ = ["TimedResult", "count", "counters", "timed", "trace"]

counters: dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of ``counters``."""
    counters[name] = counters.get(name, 0) + int(n)


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

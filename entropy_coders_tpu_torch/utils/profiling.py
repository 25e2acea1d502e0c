"""Profiling hooks (counterpart of ``entropy_coders_tpu/utils/profiling.py``):
``trace`` captures a ``torch.profiler`` trace where the JAX package captures
a ``jax.profiler`` one; ``timed`` and ``TimedResult`` are the JAX package's
own (they import no jax)."""

from __future__ import annotations

import contextlib

import torch

from entropy_coders_tpu.utils.profiling import TimedResult, timed

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

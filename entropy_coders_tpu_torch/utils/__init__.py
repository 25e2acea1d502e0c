"""Utilities of the port: profiler traces and wall-clock timing
(``profiling``), frame statistics (``metrics``) and the bounds-checked
shared-stream cores (``checked``), the counterparts of
``entropy_coders_tpu.utils``."""

from .metrics import FrameStats, frame_stats
from .profiling import TimedResult, timed, trace

__all__ = ["FrameStats", "TimedResult", "frame_stats", "timed", "trace"]

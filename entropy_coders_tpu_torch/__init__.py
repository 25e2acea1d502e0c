"""entropy_coders_tpu_torch — the FSE (tANS) container codec on PyTorch + CUDA.

The port of ``entropy_coders_tpu`` (JAX/Pallas on a TPU) to PyTorch and
hand-written CUDA kernels for an NVIDIA H100 (sm_90a). It writes and reads
the same ``FSET`` frames (FORMAT.md), byte for byte; the JAX package stays
the reference it is held against.

* ``frame``     — ``compress``/``decompress`` of the block container;
* ``stream``    — bounded-memory file compression (atomic writes);
* ``checkpoint`` — compressed ``state_dict``/tree checkpoints with
  per-tensor range loads (``FSCK`` files, shared with the JAX package);
* ``__main__``  — the CLI, ``python -m entropy_coders_tpu_torch``;
* ``utils``     — ``frame_stats``, ``timed``, ``trace`` (torch.profiler),
  the bounds-checked cores (``utils.checked``);
* ``ops``       — per-lane kernels' wrappers and plain versions, the lane
  repack and the table build on the device (``ops.device_repack``,
  ``ops.tables``), the shared-stream cores and payload codec, the
  per-block histogram;
* ``parallel``  — block sharding over several devices, multi-process
  frames, the ring collective;
* ``kernels``   — nvcc build + ctypes load of ``csrc/*.cu``; ``builddir``
  says where it and ``native`` build;
* ``native``    — the C++ host codec (tables, header I/O, lane repack),
  built with g++ at first use; ``normalize`` and ``constants`` beside it;
* ``tools``     — the measurement scripts: the decode table-layout
  experiments and their kernel (``tools.l10_attack``), the kernels at
  their launch shapes, BASELINE's configs 1-6 (``tools.bench_configs``),
  the table-log policy sweep (``tools.policy_sweep``), the root bench's
  two lines (``tools.bench``) and the one-block and mesh dry runs
  (``tools.graft_entry``).

It imports ``torch`` and never ``jax``, and nothing of the JAX package: the
parts it needs that import no jax (``normalize``, ``native``,
``constants``) are copied into it.
"""

from .constants import TABLE_LOG_DEFAULT, TABLE_LOG_MAX, TABLE_LOG_MIN
from .frame import compress, decompress

__version__ = "0.1.0"

__all__ = ["TABLE_LOG_DEFAULT", "TABLE_LOG_MAX", "TABLE_LOG_MIN", "compress",
           "decompress", "__version__"]

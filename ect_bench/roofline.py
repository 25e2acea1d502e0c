"""The yardstick of the kernels' roofline shares: the card's peak and the
bytes the algorithm needs for a call.

The bytes are the algorithm's, not any kernel's: a compress reads the raw
input once and writes the frame once; a decompress reads the frame once and
writes the raw bytes once. A program that fuses, splits or drops kernels
changes the time under these bytes, never the bytes.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (HBM3) data sheet: 3.35 TB/s of device memory
# bandwidth at the card's full power limit (700 W).
PEAK_BYTES_PER_S = 3.35e12


def call_bytes(op: str, raw: int, frame: int) -> int:
    """Bytes a call of ``op`` has to move: ``compress`` reads ``raw`` and
    writes ``frame``; ``decompress`` and ``read`` read the ``frame`` bytes
    they decode and write ``raw``."""
    if op not in ("compress", "decompress", "read"):
        raise ValueError(f"no byte count for {op!r}")
    return raw + frame


def share_pct(nbytes: int, kernel_s: float,
              peak: float = PEAK_BYTES_PER_S) -> float | None:
    """The least time ``nbytes`` take at ``peak`` over the kernels' time,
    in percent; None where no kernel ran."""
    if kernel_s <= 0:
        return None
    return 100.0 * nbytes / peak / kernel_s

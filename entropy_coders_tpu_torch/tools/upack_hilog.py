"""The u-packed decode layout above L = 10, on a flat 40-symbol corpus.

Counterpart of the JAX package's ``tools/upack_hilog.py``. The bench corpus
stops being u-pack eligible above L = 10 (max normalized count 410 > 256 at
L = 11), so this uses that tool's corpus: ``x**2 % 101`` for x uniform in
[0, 40), 40 distinct symbols (not ~101, as the JAX tool's comment says),
64 MiB, seed 0xA11. At 16 MiB blocks it is eligible up to L = 13 (max count
228) and not at L = 14. At L = 15 u-pack needs 2^15 entries from at most 128
symbols (0..127) of count <= 256 each, so only a table with all 128 at
exactly 256 qualifies.

The frame round-trips through the port's ``compress``/``decompress``, then
B1, ``flat`` and ``upack`` (and ``split`` up to L = 12) decode the lanes
through ``l10_attack.run_layouts``: checked against the input and B1, timed
on a CUDA device beside each instantiation's co-resident CTAs per SM.

Usage, on a machine with a CUDA device:

    python -m entropy_coders_tpu_torch.tools.upack_hilog [L]    # default 11
"""

from __future__ import annotations

import sys

import numpy as np

from ..frame import decompress
from .l10_attack import BLOCK, K, MIB, lane_inputs, run_layouts
from .l10_attack_harness import upack_ok


def corpus(size: int) -> np.ndarray:
    """The 40-symbol corpus of ``tools/upack_hilog.py:33-36``."""
    rng = np.random.default_rng(0xA11)
    return (rng.integers(0, 40, size, dtype=np.uint16) ** 2 % 101).astype(
        np.uint8)


def run(L: int = 11, size: int = 64 * MIB, device="cuda", *,
        block_size: int = BLOCK, k: int = K) -> dict:
    data = corpus(size)
    inp = lane_inputs(data, L, block_size=block_size, k=k, device=device)
    if decompress(inp.frame, device=device) != data.tobytes():
        raise RuntimeError(f"L={L}: the frame does not round-trip")
    top = int(inp.norm_tables.max())
    print(f"L={L}: frame round trip ok, max normalized count {top}",
          flush=True)
    if not upack_ok(inp.norm_tables, L):
        raise RuntimeError(f"L={L}: u-pack not eligible (max count {top})")
    return run_layouts(inp, ("flat", "upack") + (("split",) if L <= 12 else ()))


def main(argv) -> int:
    run(int(argv[1]) if len(argv) > 1 else 11)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

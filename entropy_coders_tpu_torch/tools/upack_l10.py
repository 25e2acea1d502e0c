"""The u-packed decode layout against the split layout on the bench corpus.

Counterpart of the JAX package's ``tools/upack_l10.py``: 128 MiB of
``gen_sequence(0.2)`` at 16 MiB blocks, k=16384 and table log L (default
10, where the bench corpus is u-pack eligible: max normalized count ~205 <=
256), decoded with B1, ``split`` and ``upack`` through
``l10_attack.run_layouts`` (checked against the input and B1; timed on a
CUDA device). Above L = 10 the bench corpus is not eligible and ``upack``
reports so.

Usage, on a machine with a CUDA device:

    python -m entropy_coders_tpu_torch.tools.upack_l10 [L]     # default 10
"""

from __future__ import annotations

import sys

from .bench_data import gen_sequence
from .l10_attack import BLOCK, K, MIB, lane_inputs, run_layouts


def run(L: int = 10, size: int = 128 * MIB, device="cuda", *,
        block_size: int = BLOCK, k: int = K) -> dict:
    inp = lane_inputs(gen_sequence(0.2, size), L, block_size=block_size,
                      k=k, device=device)
    return run_layouts(inp, ("split", "upack"))


def main(argv) -> int:
    run(int(argv[1]) if len(argv) > 1 else 10)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

"""Per-block byte histogram (counterpart of ``entropy_coders_tpu/ops/histogram.py``).

The JAX package counts with XLA code, not a Pallas kernel (a scatter on CPU,
an eq-scan over the 256 symbols on the TPU), so the port's counterpart is
plain PyTorch: one ``bincount`` over the block bytes offset by 256 * row,
in chunks of rows so the int64 index tensor stays bounded.
"""

from __future__ import annotations

import torch

from ..constants import ALPHABET

_CHUNK_BYTES = 1 << 24  # bytes of input per bincount (128 MiB of int64 index)


def histogram_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 -> (B, 256) int64 per-block counts, on the blocks'
    device."""
    B, n = blocks.shape
    counts = torch.empty((B, ALPHABET), dtype=torch.int64, device=blocks.device)
    rows = max(1, _CHUNK_BYTES // max(n, 1))
    for b0 in range(0, B, rows):
        chunk = blocks[b0 : b0 + rows]
        nb = chunk.shape[0]
        offset = torch.arange(nb, device=blocks.device).unsqueeze(1) * ALPHABET
        idx = (chunk.to(torch.int64) + offset).reshape(-1)
        counts[b0 : b0 + nb] = torch.bincount(
            idx, minlength=nb * ALPHABET).view(nb, ALPHABET)
    return counts

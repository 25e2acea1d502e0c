"""Per-block byte histogram (counterpart of ``entropy_coders_tpu/ops/histogram.py``).

The JAX package counts with XLA code, not a Pallas kernel (a scatter on CPU,
an eq-scan over the 256 symbols on the TPU), so the port's counterpart is
plain PyTorch: one ``bincount`` over the block bytes offset by 256 * row,
in chunks of rows so the int64 index tensor stays bounded.

Counts are int64, where the JAX package's are uint32: ``bincount`` counts
in int64, and torch has few operations on uint32 (``ops.unsigned``). The
values are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import ALPHABET
from .unsigned import entry_device, entry_tensor

_CHUNK_BYTES = 1 << 24  # bytes of input per bincount (128 MiB of int64 index)


def histogram_blocks(data_blocks, *, device=None) -> torch.Tensor:
    """(B, n) uint8 -> (B, 256) int64 per-block counts (the JAX package's
    ``ops.histogram.histogram_blocks``), on ``device``: as the lane entries
    take it (``unsigned.entry_device``), the tensor's device when None, and
    ``"cuda"`` for a numpy array. ValueError for another shape or dtype."""
    dev = entry_device(device, data_blocks)
    blocks = entry_tensor(data_blocks, np.uint8, dev)
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError(f"data_blocks must be (B, n) uint8, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    B, n = blocks.shape
    counts = torch.empty((B, ALPHABET), dtype=torch.int64, device=dev)
    rows = max(1, _CHUNK_BYTES // max(n, 1))
    for b0 in range(0, B, rows):
        chunk = blocks[b0 : b0 + rows]
        nb = chunk.shape[0]
        offset = torch.arange(nb, device=dev).unsqueeze(1) * ALPHABET
        idx = (chunk.to(torch.int64) + offset).reshape(-1)
        counts[b0 : b0 + nb] = torch.bincount(
            idx, minlength=nb * ALPHABET).view(nb, ALPHABET)
    return counts


def histogram_u8(data, *, device=None) -> torch.Tensor:
    """(n,) uint8 -> (256,) int64 counts (the JAX package's
    ``ops.histogram.histogram_u8``), on ``device``: as the lane entries
    take it (``unsigned.entry_device``), the tensor's device when None, and
    ``"cuda"`` for a numpy array."""
    dev = entry_device(device, data)
    data = entry_tensor(data, np.uint8, dev)
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError(f"data must be (n,) uint8, got {tuple(data.shape)} "
                         f"{data.dtype}")
    return histogram_blocks(data[None])[0]

"""Per-block byte histogram (counterpart of ``entropy_coders_tpu/ops/histogram.py``).

The JAX package counts with XLA code, not a Pallas kernel: on the TPU a
``lax.scan`` of 256 masked reductions (``_hist_blocks_eqsum``: its vector
unit has no fast scatter), on the CPU a scatter. The port counts on the
card with D6, a kernel written for Hopper (``csrc/histogram.cu``,
``ect_histogram``): one cooperative launch that zeroes the output, counts
16-byte loads into per-warp sub-histograms in shared memory, and adds each
slice's counts to its block's row with 64-bit atomics.
``histogram_call`` is D6's wrapper: a CUDA tensor launches the kernel (and
raises if it cannot build or launch; there is no fallback), a CPU tensor
runs the plain version, ``histogram_blocks_ref`` (an offset ``bincount``).
``HIST_LAUNCHES`` counts the launches. ``histogram_blocks`` and
``histogram_u8`` are the JAX package's entries, numpy, lists or tensors in.

Counts are int64, where the JAX package's are uint32: exact past 4 GiB a
block, and torch has few operations on uint32 (``ops.unsigned``). The
values are the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import ALPHABET
from ..kernels.launch import launch as _launch
from .unsigned import entry_device, entry_tensor

__all__ = ["HIST_LAUNCHES", "THREADS", "histogram_blocks",
           "histogram_blocks_ref", "histogram_call", "histogram_u8",
           "launch_config"]

HIST_LAUNCHES = 0  # D6 launches since import (or since a caller reset it)
THREADS = 512      # threads a CTA of D6
MAX_SLICE = 1 << 30  # bytes a slice at most: its u32 partial counts stay exact
MIN_SLICE = 1 << 15  # bytes a slice at least (one pass of a CTA's loads)
# what a unit's set-up and sum cost D6's CTA, in bytes of counting
UNIT_COST = 4096
_CHUNK_BYTES = 1 << 24  # bytes of input per bincount (128 MiB of int64 index)


def histogram_blocks_ref(blocks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of D6: (B, n) uint8 -> (B, 256) int64 counts,
    one ``bincount`` over the block bytes offset by 256 * row, in chunks of
    rows so that the int64 index stays bounded."""
    B, n = blocks.shape
    dev = blocks.device
    counts = torch.zeros((B, ALPHABET), dtype=torch.int64, device=dev)
    rows = max(1, _CHUNK_BYTES // max(n, 1))
    for b0 in range(0, B if n else 0, rows):
        chunk = blocks[b0 : b0 + rows]
        nb = chunk.shape[0]
        offset = torch.arange(nb, device=dev).unsqueeze(1) * ALPHABET
        idx = (chunk.to(torch.int64) + offset).reshape(-1)
        counts[b0 : b0 + nb] = torch.bincount(
            idx, minlength=nb * ALPHABET).view(nb, ALPHABET)
    return counts


@functools.lru_cache(maxsize=256)
def launch_config(B: int, n: int, ctas: int) -> tuple[int, int, int]:
    """(S, slice, grid) that D6 launches with for B blocks of n bytes on a
    card that holds ``ctas`` of its CTAs at once: each block is cut into S
    slices of ``slice`` bytes (a multiple of 16, at most ``MAX_SLICE``; the
    last may be shorter), and ``grid`` CTAs take the B * S units in turns.
    A block is cut only into slices of ``MIN_SLICE`` bytes or more, and
    into no more than two units a CTA. S minimises the busiest CTA's work, its units times (slice +
    ``UNIT_COST``), the smaller S on a tie. An H100 holds 396 CTAs (three
    an SM): 8 blocks of 16 MiB take 49 slices a block, 1 x 16 MiB 396, 128
    x 128 KiB and 256 x 4 MiB 3, 1,024 x 128 KiB 1."""
    if B < 1 or n < 1 or ctas < 1:
        raise ValueError(f"bad launch: {B} blocks of {n} bytes on {ctas} "
                         "CTAs")
    s_lo = -(-n // MAX_SLICE)
    s_hi = max(s_lo, min(-(-n // MIN_SLICE), -(-2 * ctas // B)))
    best = None
    for S in range(s_lo, s_hi + 1):
        slice_ = (-(-n // S) + 15) // 16 * 16
        S_eff = -(-n // slice_)
        cost = -(-B * S_eff // ctas) * (slice_ + UNIT_COST)
        if best is None or cost < best[0]:
            best = (cost, S_eff, slice_)
    _, S, slice_ = best
    return S, slice_, min(ctas, B * S)


_CTAS: dict = {}   # device index -> CTAs of D6 resident at once


def _library():
    """The kernels' library (built at first use): loaded before anything
    is allocated on the card, so that a failed build raises first."""
    from ..kernels.build import load

    return load()


def _max_ctas(lib, dev: torch.device) -> int:
    if dev.index not in _CTAS:
        got = lib.ect_histogram_max_ctas(dev.index, THREADS)
        if got <= 0:
            raise RuntimeError(f"ect_histogram_max_ctas failed: CUDA error "
                               f"{-got}")
        _CTAS[dev.index] = got
    return _CTAS[dev.index]


def histogram_call(blocks: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 tensor -> (B, 256) int64 counts on its device (D6's
    wrapper). A CUDA tensor launches D6 on its device's current stream
    (raising if the kernel cannot build or launch) and reads nothing back;
    B = 0 or n = 0 gives zeros without a launch. A CPU tensor runs
    ``histogram_blocks_ref``."""
    global HIST_LAUNCHES
    if not isinstance(blocks, torch.Tensor):
        raise TypeError(f"blocks must be a torch.Tensor, got {type(blocks)}")
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError(f"data_blocks must be (B, n) uint8, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    dev = blocks.device
    if dev.type == "cpu":
        return histogram_blocks_ref(blocks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    B, n = blocks.shape
    lib = _library()
    if B == 0 or n == 0:
        return torch.zeros((B, ALPHABET), dtype=torch.int64, device=dev)
    S, slice_, grid = launch_config(B, n, _max_ctas(lib, dev))
    out = torch.empty((B, ALPHABET), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _launch(lib.ect_histogram, blocks.data_ptr(), n, B, slice_, S, grid,
                THREADS, out.data_ptr(),
                torch._C._cuda_getCurrentRawStream(dev.index))
    HIST_LAUNCHES += 1
    return out


def histogram_blocks(data_blocks, *, device=None) -> torch.Tensor:
    """(B, n) uint8 -> (B, 256) int64 per-block counts (the JAX package's
    ``ops.histogram.histogram_blocks``), on ``device``: as the lane entries
    take it (``unsigned.entry_device``), the tensor's device when None, and
    ``"cuda"`` for a numpy array. D6 on CUDA, the plain version on the CPU
    (``histogram_call``). ValueError for another shape or dtype."""
    dev = entry_device(device, data_blocks)
    return histogram_call(entry_tensor(data_blocks, np.uint8, dev))


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
    return histogram_call(data[None])[0]

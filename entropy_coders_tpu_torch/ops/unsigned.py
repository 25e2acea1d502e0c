"""Unsigned integers across numpy, PyTorch and the card.

The wire format and the tables are unsigned (u32 stream words, u32 decode
entries, u16 next states). PyTorch has ``torch.uint32``/``torch.uint16``
but few operations on them, so tensors of those types only ever move as
views of the signed type of the same width: every copy, transfer and
comparison runs on the signed view, and arithmetic widens to int64 first
(torch's ``>>`` on int32 is arithmetic, the wire's shifts are logical).
"""

from __future__ import annotations

import numpy as np
import torch

_SIGNED = {torch.uint32: torch.int32, torch.uint16: torch.int16}
_NP_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}
_NP_UNSIGNED = {torch.uint32: np.uint32, torch.uint16: np.uint16}
_TORCH_UNSIGNED = {np.dtype(np.uint32): torch.uint32,
                   np.dtype(np.uint16): torch.uint16}


def to_device(arr: np.ndarray, device, non_blocking: bool = False) -> torch.Tensor:
    """numpy array -> tensor on ``device``, u32/u16 kept as their type.

    ``non_blocking`` stages a copy for a CUDA device in pinned host memory
    and queues the h2d on the current stream without waiting for the work
    queued before it (a blocking h2d synchronises the stream)."""
    arr = np.ascontiguousarray(arr)
    signed = _NP_SIGNED.get(arr.dtype)
    t = torch.from_numpy(arr if signed is None else arr.view(signed))
    if non_blocking and torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t if signed is None else t.view(_TORCH_UNSIGNED[arr.dtype])


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy array, u32/u16 kept as their type."""
    signed = _SIGNED.get(t.dtype)
    if signed is None:
        return t.cpu().numpy()
    return t.view(signed).cpu().numpy().view(_NP_UNSIGNED[t.dtype])


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """The same memory as the signed type of equal width (u8 stays u8)."""
    signed = _SIGNED.get(t.dtype)
    return t if signed is None else t.view(signed)


def as_int64(t: torch.Tensor) -> torch.Tensor:
    """Widen to int64 by value: u32/u16 bit patterns read as unsigned."""
    signed = _SIGNED.get(t.dtype)
    if signed is None:
        return t.to(torch.int64)
    bits = 32 if t.dtype == torch.uint32 else 16
    return t.view(signed).to(torch.int64) & ((1 << bits) - 1)


def int64_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> a torch.uint32 tensor of the same
    values (through an exact int32 cast of the two's-complement value)."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32).view(
        torch.uint32)

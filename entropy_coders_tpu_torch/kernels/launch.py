"""What every kernel wrapper does around its launch: check the tensors it
was given, and raise when the launcher reports a CUDA error."""

from __future__ import annotations

import torch


def check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, want {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")

"""Byte rows for the histogram tests (``tests/test_torch_histogram.py``,
``tests/test_torch_histogram_emulated.py``), made from a seed with numpy:
the kinds of data that pile counts onto a few bins or spread them."""

import numpy as np

KINDS = ("uniform", "constant", "geometric", "bf16")


def rows(kind: str, B: int, n: int, seed: int) -> np.ndarray:
    """(B, n) uint8: ``uniform`` bytes over all 256 values; ``constant``,
    one value a row (a row of its own value); ``geometric``, byte s with
    probability ~0.2 * 0.8^s; ``bf16``, the bytes of bf16 normals (the
    exponent bytes on a few bins)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 256, (B, n), dtype=np.uint8)
    if kind == "constant":
        vals = rng.integers(0, 256, B, dtype=np.uint8)
        return np.repeat(vals[:, None], n, axis=1)
    if kind == "geometric":
        return np.minimum(rng.geometric(0.2, (B, n)) - 1, 255).astype(np.uint8)
    if kind == "bf16":
        x = rng.standard_normal(B * (n // 2 + 1)).astype(np.float32)
        b = (x.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8)
        return b[: B * n].reshape(B, n).copy()
    raise ValueError(f"unknown kind {kind}")

"""Vectorized batch normalization for many blocks at once (a copy of
``entropy_coders_tpu/normalize.py``).

Semantically identical to the reference's ``Histogram::normalize``
(src/histogram.rs:93-155), vectorized over a batch of block histograms with
exact numpy uint64 fixed-point arithmetic (``t*step`` < 2**62, no
overflow). Rows that hit the rare slow path (src/histogram.rs:144-145) or
the single-symbol early return go through the port's C++ ``ect_normalize``
(``native.normalize``), one row at a time, where the JAX package takes its
``spec`` histogram. The results are byte-identical to the JAX package's
``normalize_batch``; ``tests/test_torch_host.py`` holds them against it.

Normalization is O(256) per block, host metadata work.
"""

from __future__ import annotations

import numpy as np

from . import native
from .constants import TABLE_LOG_DEFAULT, TABLE_LOG_MAX, TABLE_LOG_MIN

# reference src/histogram.rs: the rest-to-beat table of the small-count
# rounding rule
_RTB = np.array([0, 473195, 504333, 520860, 550000, 700000, 750000, 830000],
                dtype=np.uint64)


def table_lens(counts: np.ndarray) -> np.ndarray:
    """(B, 256) -> (B,) table_len per row (1 + last nonzero index)."""
    nz = counts != 0
    return np.where(nz.any(axis=1), 255 - np.argmax(nz[:, ::-1], axis=1) + 1, 1)


def _ilog2_scalar(x: int) -> int:
    return max(int(x), 1).bit_length() - 1


def _min_log2s(counts: np.ndarray) -> np.ndarray:
    """Per-row table_len clamp floor ``ilog2(table_len - 1) + 2``
    (reference: src/histogram.rs:96-98)."""
    tl = table_lens(counts)
    return np.floor(np.log2(np.maximum(tl - 1, 1))).astype(np.int64) + 2


def optimal_log2s(counts: np.ndarray, size: int) -> np.ndarray:
    """Per-row reference ``optimal_log2`` (src/histogram.rs:264-277):
    ``min(11, ilog2(size-1)-2)`` raised to
    ``min(ilog2(size)+1, ilog2(table_len-1)+2)``, clamped to [5, 15].
    Vectorized over (B, 256) histograms of equal-``size`` blocks."""
    if size < 2 or _ilog2_scalar(size - 1) - 2 < 0:
        raise ValueError("input too small to normalize")
    min_bits = np.minimum(_ilog2_scalar(size) + 1, _min_log2s(counts))
    v = min(TABLE_LOG_DEFAULT, _ilog2_scalar(size - 1) - 2)
    return np.clip(np.maximum(v, min_bits), TABLE_LOG_MIN, TABLE_LOG_MAX)


def effective_log2(counts: np.ndarray, size: int, log2) -> np.ndarray:
    """Per-row effective log2 after the reference's clamp
    (src/histogram.rs:96-98). ``log2`` may be a scalar, a per-row array,
    or the string ``"auto"`` (per-row reference ``optimal_log2``)."""
    if isinstance(log2, str):
        if log2 != "auto":
            raise ValueError(f"bad table_log {log2!r}")
        base = optimal_log2s(counts, size)
    else:
        base = np.clip(np.asarray(log2), TABLE_LOG_MIN, TABLE_LOG_MAX)
    return np.maximum(base, _min_log2s(counts))


def normalize_batch(counts: np.ndarray, size: int, log2):
    """Normalize (B, 256) uint histograms of equal-size blocks.

    Returns ``(tables (B,256) int32, log2s (B,) int64)``. ``log2`` is the
    requested table log (scalar, per-row array, ``"auto"`` for the
    reference's per-block ``optimal_log2`` policy, ``"fast"`` for the
    throughput-biased policy below, or ``("fast", eps)`` to widen/narrow
    that policy's size budget — e.g. ``("fast", 0.015)`` admits the L=8
    throughput-max point on the bench distribution where the default
    0.5% budget stops at L=9); per-row it may be raised by the
    reference's table_len clamp (rare: only for blocks with few distinct
    symbols)."""
    counts = np.asarray(counts, dtype=np.uint64)
    if isinstance(log2, str) and log2 == "fast":
        return normalize_batch(counts, size, fast_log2s(counts, size))
    if isinstance(log2, tuple):
        if len(log2) != 2 or log2[0] != "fast":
            raise ValueError(f"bad table_log {log2!r}")
        return normalize_batch(
            counts, size, fast_log2s(counts, size, eps=float(log2[1])))
    log2s = effective_log2(counts, size, log2)
    return _tables_at(counts, size, log2s), log2s


def _tables_at(counts: np.ndarray, size: int, log2s: np.ndarray) -> np.ndarray:
    tables = np.zeros((counts.shape[0], 256), dtype=np.int32)
    for l2 in np.unique(log2s):
        rows = np.flatnonzero(log2s == l2)
        tables[rows] = _normalize_rows(counts[rows], size, int(l2))
    return tables


# "fast" policy knobs: candidate logs auto-FAST_SPAN..auto, accept the
# smallest whose estimated coded size is within FAST_EPS of auto's.
FAST_EPS = 0.005
FAST_SPAN = 3


def estimated_bits(counts: np.ndarray, tables: np.ndarray,
                   log2s: np.ndarray) -> np.ndarray:
    """Per-row estimated coded size in bits: the tANS cost model
    ``sum_i c_i * (L - log2(n_i))`` (a symbol with ``n_i`` of the ``2^L``
    table slots codes in ``L - log2(n_i)`` bits on average; the ``-1``
    low-prob sentinel owns 1 slot = L bits) plus an NCount header
    estimate of ``table_len * (L + 1)`` bits. Float estimate — used for
    policy decisions, never for buffer sizing."""
    c = counts.astype(np.float64)
    n = np.where(tables > 0, tables, 1).astype(np.float64)
    L = np.asarray(log2s, np.float64)[:, None]
    payload = np.where(counts != 0, c * (L - np.log2(n)), 0.0).sum(axis=1)
    return payload + table_lens(counts) * (np.asarray(log2s) + 1)


def fast_log2s(counts: np.ndarray, size: int, eps: float = FAST_EPS,
               span: int = FAST_SPAN) -> np.ndarray:
    """Throughput-biased per-block table log (``table_log="fast"``), the
    JAX package's policy; it changes the frame's bytes, so the port keeps
    it as it is.

    It starts from the reference's ``optimal_log2`` (ratio-optimal;
    src/histogram.rs:264-277) and takes the SMALLEST log within ``span``
    of it whose estimated coded size (``estimated_bits``) stays within
    ``eps`` of the optimal log's: the fastest table (smaller tables decode
    faster) that does not meaningfully hurt the ratio. The reference has
    no such policy (it has one fixed default)."""
    counts = np.asarray(counts, dtype=np.uint64)
    base = effective_log2(counts, size, "auto")
    lo = np.maximum(np.maximum(base - span, _min_log2s(counts)),
                    TABLE_LOG_MIN)

    budget = estimated_bits(counts, _tables_at(counts, size, base),
                            base) * (1.0 + eps)
    chosen = base.copy()
    done = np.zeros(len(base), dtype=bool)
    prev = base
    for delta in range(span, 0, -1):  # smallest candidate log first
        Ls = np.maximum(base - delta, lo)
        # only rows still undecided whose candidate actually changed
        # (rows clamped to lo repeat the same Ls every iteration)
        idx = np.flatnonzero(~done & (Ls < base) & (Ls != prev))
        prev = Ls
        if not idx.size:
            continue
        est = estimated_bits(counts[idx],
                             _tables_at(counts[idx], size, Ls[idx]),
                             Ls[idx])
        take = idx[est <= budget[idx]]
        chosen[take] = Ls[take]
        done[take] = True
    return chosen


def _normalize_rows(t: np.ndarray, size: int, log2: int) -> np.ndarray:
    """Fast-path vectorized normalize for rows sharing one log2."""
    B = t.shape[0]
    scale = np.uint64(62 - log2)
    step = np.uint64((1 << 62) // size)
    v_step = np.uint64(1) << np.uint64(62 - log2 - 20)
    low_threshold = np.uint64(size >> log2)

    nonzero = t != 0
    is_low = nonzero & (t <= low_threshold)
    main = nonzero & ~is_low

    prod = t * step
    prob = prod >> scale
    small = main & (prob < 8)
    rtb = _RTB[np.minimum(prob, 7).astype(np.int64)]
    bump = small & ((prod - (prob << scale)) > (v_step * rtb))
    prob = (prob + bump).astype(np.int64)

    norm = np.where(main, prob, np.where(is_low, -1, 0)).astype(np.int64)

    assigned = np.where(main, prob, np.where(is_low, 1, 0))
    to_distribute = (1 << log2) - assigned.sum(axis=1)

    # largest symbol: first index attaining the max prob among main-path
    # symbols (strict '>' update in the reference => first max).
    masked = np.where(main, prob, -1)
    largest = np.argmax(masked, axis=1)
    largest_prob = masked[np.arange(B), largest]

    out = norm.astype(np.int32)
    out[np.arange(B), largest] += to_distribute.astype(np.int32)

    # rows needing exact scalar treatment: the degenerate single-symbol
    # early return (t == size) and the slow path.
    degenerate = (t == np.uint64(size)).any(axis=1)
    slow = (to_distribute != 0) & (-to_distribute >= (largest_prob >> 1))
    for r in np.flatnonzero(degenerate | slow):
        out[r] = native.normalize(t[r], size, log2)[0]  # t is uint64-exact
    return out

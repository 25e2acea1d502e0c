"""The FSE (tANS) pieces of the plain reference: byte histograms, their
normalization and table-log policies, the zstd-format table header, and the
encode and decode tables.

Written from the reference crate's semantics (src/histogram.rs, src/fse.rs)
in plain Python and NumPy. It imports nothing of the program it judges.
"""

from __future__ import annotations

import numpy as np

LOG_MIN, LOG_MAX, LOG_DEFAULT = 5, 15, 11
U32 = 0xFFFFFFFF
# rest-to-beat thresholds of the small-probability rounding (histogram.rs:100)
_RTB = (0, 473195, 504333, 520860, 550000, 700000, 750000, 830000)
FAST_SPAN = 3


def ilog2(x: int) -> int:
    return max(int(x), 1).bit_length() - 1


def table_len(table) -> int:
    nz = np.flatnonzero(np.asarray(table))
    return int(nz[-1]) + 1 if nz.size else 1


# --- normalization -----------------------------------------------------------


def _min_log2(counts) -> int:
    return ilog2(table_len(counts) - 1) + 2


def optimal_log2(counts, size: int) -> int:
    """The reference's ``optimal_log2`` (histogram.rs:264-277)."""
    max_bits = ilog2(size - 1) - 2
    if size < 2 or max_bits < 0:
        raise ValueError("input too small to normalize")
    v = max(min(LOG_DEFAULT, max_bits), min(ilog2(size) + 1,
                                            _min_log2(counts)))
    return min(max(v, LOG_MIN), LOG_MAX)


def normalize(counts, size: int, log2: int) -> tuple[np.ndarray, int]:
    """``Histogram::normalize`` (histogram.rs:93-155): (table (256,) int64
    summing to 2^log2 with -1 for a low-probability symbol, log2 after the
    clamp)."""
    counts = [int(c) for c in counts]
    tl = table_len(counts)
    log2 = max(min(max(log2, LOG_MIN), LOG_MAX), ilog2(tl - 1) + 2)
    scale = 62 - log2
    step = (1 << 62) // size
    v_step = 1 << (scale - 20)
    low = size >> log2
    left = 1 << log2
    largest = largest_prob = 0
    table = [0] * 256
    for i in range(tl):
        t = counts[i]
        if t == size:  # one symbol: it takes the whole table
            table[i] = left
            return np.array(table, np.int64), log2
        if t == 0:
            continue
        if t <= low:
            table[i] = -1
            left -= 1
            continue
        prob = (t * step) >> scale
        if prob < 8:
            prob += int(t * step - (prob << scale) > v_step * _RTB[prob])
        if prob > largest_prob:
            largest_prob, largest = prob, i
        table[i] = prob
        left -= prob
    if left != 0 and -left >= (largest_prob >> 1):
        return _normalize_slow(counts, size, log2, tl), log2
    table[largest] += left
    return np.array(table, np.int64), log2


def _normalize_slow(counts, size, log2, tl) -> np.ndarray:
    """``normalize_slow`` (histogram.rs:157-261)."""
    UNSET = -2
    low = size >> log2
    low_one = (size * 3) >> (log2 + 1)
    table = [0] * 256
    left, total = 1 << log2, size
    for i in range(tl):
        t = counts[i]
        if t == 0:
            continue
        if t <= low:
            table[i], left, total = -1, left - 1, total - t
        elif t <= low_one:
            table[i], left, total = 1, left - 1, total - t
        else:
            table[i] = UNSET
    if left == 0:
        return np.array(table, np.int64)
    if total // left > low_one:
        lim = (total * 3) // (left * 2)
        for i in range(tl):
            if table[i] == UNSET and counts[i] <= lim:
                table[i], left, total = 1, left - 1, total - counts[i]
    if (1 << log2) - left == tl:
        table[int(np.argmax(counts))] += left
    elif total == 0:
        while left:
            for i in range(tl):
                if table[i] > 0:
                    table[i] += 1
                    left -= 1
                    if not left:
                        break
    else:
        vlog = 62 - log2
        mid = (1 << (vlog - 1)) - 1
        r_step = ((1 << vlog) * left + mid) // total
        acc = mid
        for i in range(tl):
            if table[i] == UNSET:
                end = acc + counts[i] * r_step
                w = (end >> vlog) - (acc >> vlog)
                if w < 1:
                    raise ValueError("distribution too skewed to normalize")
                table[i], acc = w, end
    return np.array(table, np.int64)


def estimated_bits(counts, table, log2: int) -> float:
    """The "fast" policy's cost model: sum of c * (L - log2(n)) over the
    present symbols (n = 1 for a -1 slot), plus table_len * (L + 1) bits of
    header. Evaluated as one (1, 256) row, in float64."""
    c = np.asarray(counts, np.uint64)[None].astype(np.float64)
    t = np.asarray(table, np.int64)[None]
    n = np.where(t > 0, t, 1).astype(np.float64)
    present = np.asarray(counts)[None] != 0
    payload = np.where(present, c * (float(log2) - np.log2(n)), 0.0).sum(axis=1)
    return float(payload[0] + table_len(counts) * (log2 + 1))


def policy_table(counts, size: int, policy) -> tuple[np.ndarray, int]:
    """The normalized table a table-log policy gives: an int (clamped as
    ``normalize`` clamps it), ``"auto"`` (``optimal_log2``), or
    ``["fast", eps]`` / ``"fast"`` (eps 0.005): the smallest log within 3
    below the auto one whose estimated size is within ``eps`` of the auto
    one's."""
    if isinstance(policy, (int, np.integer)):
        return normalize(counts, size, int(policy))
    if policy == "auto":
        return normalize(counts, size, optimal_log2(counts, size))
    if policy == "fast" or (isinstance(policy, (list, tuple))
                            and len(policy) == 2 and policy[0] == "fast"):
        eps = 0.005 if policy == "fast" else float(policy[1])
        base = max(optimal_log2(counts, size), _min_log2(counts))
        best = normalize(counts, size, base)
        budget = estimated_bits(counts, best[0], base) * (1.0 + eps)
        lo = max(base - FAST_SPAN, _min_log2(counts), LOG_MIN)
        for cand in sorted({max(base - d, lo) for d in range(FAST_SPAN, 0, -1)}):
            if cand >= base:
                continue
            tab = normalize(counts, size, cand)
            if estimated_bits(counts, tab[0], cand) <= budget:
                return tab
        return best
    raise ValueError(f"unknown table-log policy {policy!r}")


# --- the table header (zstd format) -------------------------------------------


def write_header(table, log2: int) -> bytes:
    """The table-description header (histogram.rs:376-431)."""
    acc = nbits = 0

    def put(v, n):
        nonlocal acc, nbits
        acc |= (int(v) & ((1 << n) - 1)) << nbits
        nbits += n

    put(log2 - LOG_MIN, 4)
    threshold = 1 << log2
    remaining = threshold + 1
    zeros = 0
    width = log2 + 1
    for idx in range(table_len(table)):
        if remaining <= 1:
            break
        s = int(table[idx])
        if zeros:
            if s == 0:
                zeros += 1
                continue
            zeros -= 1
            while zeros >= 24:
                put(0xFFFF, 16)
                zeros -= 24
            while zeros >= 3:
                put(3, 2)
                zeros -= 3
            put(zeros, 2)
        mx = (2 * threshold - 1) - remaining
        remaining -= abs(s)
        count = s + 1
        if count >= threshold:
            count += mx
        put(count, width - (1 if count < mx else 0))
        zeros = 1 if count == 1 else 0
        if remaining < 1:
            raise ValueError("table does not sum to 2^log2")
        while remaining < threshold:
            width -= 1
            threshold >>= 1
    return acc.to_bytes((nbits + 7) // 8, "little") if nbits else b""


def read_header(data: bytes) -> tuple[np.ndarray, int, int]:
    """Parse a header off the front of ``data`` (histogram.rs:436-505):
    (table (256,) int64, log2, bytes used). Raises ValueError."""
    total = len(data) * 8
    # a header of 256 symbols takes under 600 bytes: parse only the front
    buf = int.from_bytes(data[:1024], "little")
    at = 0

    def peek(n):
        if at + n > total:
            raise EOFError
        return (buf >> at) & ((1 << n) - 1)

    def peek0(n):
        try:
            return peek(n)
        except EOFError:
            return 0

    try:
        if not data:
            raise EOFError
        log2 = peek(4) + LOG_MIN
        at += 4
        if log2 > LOG_MAX:
            raise ValueError("table log above 15")
        table = np.zeros(256, np.int64)
        sym, threshold = 0, 1 << log2
        remaining, width, prev0 = threshold + 1, log2 + 1, False
        while remaining > 1 and sym < 256:
            if prev0:
                while peek0(16) == 0xFFFF:
                    peek(16)
                    at += 16
                    sym += 24
                while peek0(2) == 3:
                    at += 2
                    sym += 3
                sym += peek(2)
                at += 2
            if sym >= 256:
                break
            mx = (2 * threshold - 1) - remaining
            try:
                raw = peek(width)
            except EOFError:
                raw = peek(width - 1)
            if (raw & (threshold - 1)) < mx:
                peek(width - 1)
                at += width - 1
                value = raw & (threshold - 1)
            else:
                peek(width)
                at += width
                value = raw & (2 * threshold - 1)
                if value >= threshold:
                    value -= mx
            value -= 1
            remaining -= abs(value)
            table[sym] = value
            sym += 1
            prev0 = value == 0
            while remaining < threshold:
                width -= 1
                threshold >>= 1
    except EOFError as e:
        raise ValueError("truncated table header") from e
    if remaining != 1:
        raise ValueError("table header does not sum to 2^log2")
    return table, log2, (at + 7) // 8


# --- tables -------------------------------------------------------------------


def spread(table, log2: int) -> np.ndarray:
    """Slot -> symbol (fse.rs:101-151): -1 symbols from the top down, the
    rest placed by the step (5/8 size + 3), skipping the top area."""
    size = 1 << log2
    tl = table_len(table)
    counts = np.asarray(table[:tl], np.int64)
    low = counts == -1
    high = size - 1 - int(low.sum())
    symbols = np.zeros(size, np.int64)
    symbols[size - 1: high: -1] = np.flatnonzero(low)
    seq = np.repeat(np.arange(tl), np.where(low, 0, np.maximum(counts, 0)))
    pos = (np.arange(size, dtype=np.int64) * (size * 5 // 8 + 3)) & (size - 1)
    kept = pos[pos <= high]
    if kept.size != seq.size:
        raise ValueError("table does not fill its slots")
    symbols[kept] = seq
    return symbols


class DecodeTable:
    """symbol, num_bits, new_state per state (fse.rs:253-339)."""

    def __init__(self, table, log2: int):
        size = 1 << log2
        sym = spread(table, log2)
        t = np.zeros(256, np.int64)
        t[: len(table)] = np.asarray(table, np.int64)
        start = np.where(t == -1, 1, t)
        # each slot takes its symbol's next counter value, in slot order
        order = np.argsort(sym, kind="stable")
        rank = np.empty(size, np.int64)
        rank[order] = np.arange(size)
        first = np.concatenate([[0], np.cumsum(np.bincount(sym, minlength=256))])
        nxt = start[sym] + rank - first[sym]
        nb = log2 - np.floor(np.log2(nxt)).astype(np.int64)
        self.symbol = sym
        self.num_bits = nb
        self.new_state = (nxt << nb) - size


class EncodeTable:
    """next-state table and symbol transforms (fse.rs:72-194)."""

    def __init__(self, table, log2: int):
        size = 1 << log2
        sym = spread(table, log2)
        self.next = size + np.argsort(sym, kind="stable").astype(np.int64)
        self.tt_bits = np.zeros(256, np.int64)
        self.tt_find = np.zeros(256, np.int64)
        total = 0
        for s in range(256):
            x = int(table[s]) if s < len(table) else 0
            if x == 0:
                self.tt_bits[s] = (((log2 + 1) << 16) - size) & U32
            elif x in (-1, 1):
                self.tt_bits[s] = ((log2 << 16) - size) & U32
                self.tt_find[s] = total - 1
                total += 1
            else:
                mbo = log2 - ilog2(x - 1)
                self.tt_bits[s] = ((mbo << 16) - (x << mbo)) & U32
                self.tt_find[s] = total - x
                total += x

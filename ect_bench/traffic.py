"""The one generator every traffic mix drives: a closed loop with one caller.

A traffic file (``traffic/<name>.json``) holds only parameters:

* ``input_bytes``: the cell makes as many inputs of its configuration's
  size from the seed (streams 0, 1, ...) as these bytes need, at least
  one; iteration i works on input i mod their number. In a loop that
  compresses, iteration i compresses that input rotated and with its byte
  values relabeled, both drawn for the iteration from the seed
  (``Relabel``): every call sees other bytes of the same distribution, as
  a writer's buffers differ;
* ``ops``: what one iteration calls, in order: ``compress`` (the buffer,
  whole), ``decompress`` (the buffer's newest frame, whole) or ``read``
  (``decompress(frame, start=, length=)`` of the buffer's frame);
* ``prepare``: compress every buffer in set-up, for loops that decompress
  or read before they compress;
* ``read``: ``{"length_min": a, "length_max": b, "grid": n}``: a read's
  length is one of n log-uniform quantiles of [a, b], each n reads a new
  permutation of them, and its start is uniform over the bytes where it
  fits. Every seed reads the same lengths, in another order;
* ``sample``: per op, how many answers are kept for the check once the
  window has closed (a uniform sample of the calls, drawn from the seed);
* ``trace_calls``: in a traced run, how many calls the profiler sees
  (default: the whole window); the rest of the window runs untraced.
"""

from __future__ import annotations

import math

import numpy as np

from .data import seed_words

_READ_TAG, _SAMPLE_TAG, _RELABEL_TAG = 0x4EAD, 0x5A3F, 0x4E1A


class Reads:
    """The (start, length) draws of a read loop over ``size`` bytes."""

    def __init__(self, spec: dict, size: int, seed: int):
        n = int(spec["grid"])
        lo, hi = math.log(spec["length_min"]), math.log(spec["length_max"])
        q = (np.arange(n) + 0.5) / n
        self.lengths = np.minimum(np.exp(lo + q * (hi - lo)).astype(np.int64),
                                  size)
        self.size = size
        self.rng = np.random.default_rng(seed_words(seed) + [_READ_TAG])
        self.order: list = []

    def next(self) -> tuple[int, int]:
        if not self.order:
            self.order = list(self.rng.permutation(self.lengths))
        length = int(self.order.pop())
        start = int(self.rng.integers(0, self.size - length + 1))
        return start, length


class Relabel:
    """The per-iteration inputs of a loop that compresses. Iteration i takes
    buffer i mod ``n_bufs``, rotated by an offset drawn for the iteration
    from the seed (the block boundaries fall elsewhere in the stream) and
    with every byte XORed with a key drawn with it. The key has no bit at or
    above the top bit of the buffer's largest byte, so the XOR maps byte
    values one to one within the buffer's range and leaves the top set bit
    of the largest byte in place: each input keeps its buffer's
    distribution (the same counts under other symbols, the same smallest
    table log a block allows) while its bytes, histograms and frame differ,
    so no answer or table of one call serves another."""

    def __init__(self, seed: int, bufs: list):
        self.words = seed_words(seed) + [_RELABEL_TAG]
        self.bufs = bufs
        # keys below the top bit of each buffer's largest byte
        self.key_span = [1 << max(int(b.max()).bit_length() - 1, 0)
                         for b in bufs]
        size = max(len(b) for b in bufs)
        self.work = np.ones(size, np.uint8)  # touched once, in set-up

    def draw(self, it: int) -> tuple[int, int, int]:
        """Iteration ``it``'s (buffer, offset, key)."""
        b = it % len(self.bufs)
        rng = np.random.default_rng(self.words + [it])
        return (b, int(rng.integers(0, len(self.bufs[b]))),
                int(rng.integers(0, self.key_span[b])))

    def apply(self, it: int, fresh: bool = False) -> np.ndarray:
        """Iteration ``it``'s input: into the reused array, or into a new
        one where ``fresh``."""
        b, off, key = self.draw(it)
        buf = self.bufs[b]
        n = len(buf)
        out = np.empty_like(buf) if fresh else self.work[:n]
        _xor(buf[off:], key, out[: n - off])
        _xor(buf[:off], key, out[n - off:])
        return out


def _xor(src: np.ndarray, key: int, dst: np.ndarray) -> None:
    """dst = src ^ key, eight bytes a word where the length allows."""
    m = len(src) // 8 * 8
    np.bitwise_xor(src[:m].view(np.uint64),
                   np.uint64(key * 0x0101010101010101),
                   out=dst[:m].view(np.uint64))
    np.bitwise_xor(src[m:], np.uint8(key), out=dst[m:])


class Sample:
    """A uniform sample of at most ``k`` of the calls of one op (reservoir
    sampling from the seed): ``offer`` says whether the answer of call i is
    kept, and in which slot."""

    def __init__(self, k: int, seed: int, op: str):
        self.k = k
        self.kept: list = []
        self.seen = 0
        tag = sum(op.encode())
        self.rng = np.random.default_rng(seed_words(seed) + [_SAMPLE_TAG, tag])

    def offer(self, item) -> None:
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.kept.append(item)
        elif self.k:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.kept[j] = item


def check_spec(spec: dict) -> None:
    """Refuse a traffic file the loop cannot drive."""
    ops = spec.get("ops")
    if not ops or any(op not in ("compress", "decompress", "read")
                      for op in ops):
        raise ValueError(f"traffic ops {ops!r}: each must be compress, "
                         "decompress or read")
    if ops[0] != "compress" and not spec.get("prepare"):
        raise ValueError("a loop that starts with a decompress or read "
                         "needs prepare: true")
    if "read" in ops and "read" not in spec:
        raise ValueError("a read loop needs its read parameters")

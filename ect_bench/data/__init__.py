"""Seeded inputs of the benchmark's cells.

Every generator here takes the run's ``--seed`` and a size, and nothing
else: the same seed gives the same bytes on every machine, whatever the
checkout holds besides this folder.

* ``gen_sequence`` — the reference crate's benchmark distribution
  (``benches/fse_benchmark.rs``: symbol s holds ~prob * (1 - prob)^s of a
  4096-entry lookup table), a copy of the port's
  ``tools/bench_data.gen_sequence`` with the seed taken whole;
* ``text`` — a stand-in for Wikipedia text (enwik8/enwik9) drawn from the
  frozen vocabulary ``vocab.txt`` beside this file, in chunks of 16 MiB,
  each from its own stream of the seed, on a few threads.

``make(spec, size, seed, stream)`` builds the bytes a configuration's
``data`` entry names; a cell's buffers are streams 0, 1, ... of its seed.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path

import numpy as np

__all__ = ["gen_sequence", "make", "seed_words", "text"]

_VOCAB = Path(__file__).resolve().parent / "vocab.txt"
# keep each generator's streams apart from other users of a seed
_SEQ_TAG, _TEXT_TAG = 0x5E9, 0x7E47
_CHUNK = 1 << 24  # output bytes drawn from one stream
_LUT_BITS = 22  # token probabilities quantized to 2^-22


def seed_words(seed: int) -> list[int]:
    """``seed`` (any whole number, negative or past 64 bits) as the list of
    32-bit words that numpy's ``SeedSequence`` takes: its sign, then its
    magnitude from the low word up."""
    mag, words = abs(int(seed)), []
    while True:
        words.append(mag & 0xFFFFFFFF)
        mag >>= 32
        if not mag:
            break
    return [1 if seed < 0 else 0] + words


def gen_sequence(prob: float, size: int, seed: int,
                 stream: int = 0) -> np.ndarray:
    """``size`` bytes of the reference benchmark's distribution: symbol s
    holds ~prob * (1 - prob)^s of a 4096-entry lookup table, indexed by
    uniform random u16s drawn from stream ``stream`` of ``seed``."""
    LUT_SIZE = 4096
    lut = np.zeros(LUT_SIZE, dtype=np.uint8)
    prob = min(max(prob, 0.005), 0.995)
    remaining, idx, s = LUT_SIZE, 0, 0
    while remaining > 0:
        n = max(int(remaining * prob), 1)
        lut[idx: idx + n] = s
        idx += n
        s = (s + 1) & 0xFF
        remaining -= n
    r = np.random.default_rng(seed_words(seed) + [_SEQ_TAG, stream])
    i = r.integers(0, 1 << 16, size=size, dtype=np.uint16)
    return lut[i & (LUT_SIZE - 1)]


# How a drawn word is written: (prefix, capitalised, suffix, weight). The
# markup is MediaWiki's, as enwik8/enwik9 hold it.
_FORMS = (
    ("", False, " ", 0.700),
    ("", True, " ", 0.080),
    ("", False, ", ", 0.060),
    ("", False, ". ", 0.045),
    ("", True, ". ", 0.010),
    ("[[", False, "]] ", 0.040),
    ("[[", True, "]] ", 0.020),
    ("", False, "\n", 0.015),
    ("'''", True, "''' ", 0.006),
    ("", False, "|", 0.008),
    ("(", False, ") ", 0.010),
    ("", False, "&quot; ", 0.006),
)
# Tokens drawn besides words, with their share of all tokens.
_EXTRA = (
    (tuple(f"{y} ".encode() for y in range(1700, 2011)), 0.020),
    (tuple(f"{n} ".encode() for n in range(0, 100)), 0.010),
    ((b"\n\n", b"\n== ", b" ==\n", b"\n* ", b"{{cite ", b"}}\n",
      b"<ref>", b"</ref>", b"&lt;", b"&gt;", b"http://www.", b".org/"),
     0.012),
)


@lru_cache(maxsize=1)
def _tokens():
    """(table (T, W) uint8 padded tokens, lens (T,), lut (2^22,) token
    ids, the mean token length under the lut): the token table and its
    quantized sampling table, built from ``vocab.txt`` alone."""
    words, weights = [], []
    for line in _VOCAB.read_text(encoding="ascii").splitlines():
        if line and not line.startswith("#"):
            w, c = line.split("\t")
            words.append(w)
            weights.append(float(c))
    p_word = np.asarray(weights) / sum(weights)
    share_words = 1.0 - sum(s for _, s in _EXTRA)
    form_w = np.array([f[3] for f in _FORMS])
    form_w /= form_w.sum()
    toks, probs = [], []
    for w, pw in zip(words, p_word):
        for (pre, cap, suf, _), pf in zip(_FORMS, form_w):
            body = w[:1].upper() + w[1:] if cap else w
            toks.append((pre + body + suf).encode("ascii"))
            probs.append(share_words * pw * pf)
    for group, share in _EXTRA:
        toks.extend(group)
        probs.extend([share / len(group)] * len(group))
    probs = np.asarray(probs)
    slots = 1 << _LUT_BITS
    q = np.maximum(np.floor(probs * slots).astype(np.int64), 1)
    q[np.argmax(q)] += slots - int(q.sum())
    width = max(len(t) for t in toks)
    table = np.zeros((len(toks), width), np.uint8)
    lens = np.array([len(t) for t in toks], np.int64)
    for i, t in enumerate(toks):
        table[i, : len(t)] = np.frombuffer(t, np.uint8)
    lut = np.repeat(np.arange(len(toks), dtype=np.int32), q)
    return table, lens, lut, float(lens[lut].mean())


def _text_chunk(seed: int, stream: int, c: int, n: int) -> np.ndarray:
    """Chunk ``c`` of text stream ``stream`` of ``seed``: its first ``n``
    bytes (n <= _CHUNK; a chunk's bytes do not depend on ``n``)."""
    table, lens, lut, mean = _tokens()
    rng = np.random.default_rng(seed_words(seed) + [_TEXT_TAG, stream, c])
    draw = int(_CHUNK / mean * 1.05) + 1024
    ids = lut[rng.integers(0, 1 << _LUT_BITS, size=draw, dtype=np.uint32)]
    while int(lens[ids].sum()) < _CHUNK:  # rare: draw more from the stream
        more = lut[rng.integers(0, 1 << _LUT_BITS, size=draw // 8 + 1024,
                                dtype=np.uint32)]
        ids = np.concatenate([ids, more])
    keep = int(np.searchsorted(np.cumsum(lens[ids]), n)) + 1
    flat = table[ids[:keep]].reshape(-1)
    return flat[flat != 0][:n]  # no token holds a 0 byte: it is the padding


def text(size: int, seed: int, stream: int = 0,
         threads: int | None = None) -> np.ndarray:
    """``size`` bytes of text stream ``stream`` of ``seed``: chunk c is
    drawn from its own generator (seed, stream, c), so a longer draw
    extends a shorter one. The
    chunks are drawn on ``threads`` threads (default: the host's cores, at
    most 16); the bytes do not depend on it."""
    threads = threads or min(16, os.cpu_count() or 1)
    out = np.empty(size, np.uint8)
    starts = range(0, size, _CHUNK)

    def fill(i0: int) -> None:
        n = min(_CHUNK, size - i0)
        out[i0: i0 + n] = _text_chunk(seed, stream, i0 // _CHUNK, n)

    _tokens()  # built once, before the threads share it
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(fill, starts))
    return out


def make(spec: dict, size: int, seed: int, stream: int = 0) -> np.ndarray:
    """The bytes a configuration's ``data`` entry names, ``size`` long,
    from stream ``stream`` of ``seed``: ``{"kind": "gen_sequence", "prob":
    p}`` or ``{"kind": "text"}``."""
    kind = spec["kind"]
    if kind == "gen_sequence":
        return gen_sequence(float(spec["prob"]), size, seed, stream)
    if kind == "text":
        return text(size, seed, stream)
    raise ValueError(f"unknown data kind {kind!r}")

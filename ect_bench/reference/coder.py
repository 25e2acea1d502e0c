"""The two stream layouts of the plain reference, in NumPy, vectorised over
many streams at once.

* Per-lane streams (FORMAT.md, MODE_FSE_PL): lane i of a block codes bytes
  i, i+k, ... as its own reversed bit stack; the lane's last byte sets the
  encoder's first state, its other bytes are encoded from the last down,
  and the final state is pushed in L bits. The decoder pops that state
  first, then one symbol a round.
* One shared stream (MODE_FSE): byte i belongs to encoder i mod k; the top
  k bytes set the first states; the rest are encoded from the top down
  into one stack, the k final states (k-1 first) and a marker bit follow.

``bits_*`` run the encoders and count the bits they would push (which sets
the lane-size table and the section lengths); ``decode_*`` read the bits
back. Each table is a ``fse.DecodeTable`` / ``fse.EncodeTable``.
"""

from __future__ import annotations

import numpy as np

from .fse import U32


def stacked(tables, field: str) -> tuple[np.ndarray, int]:
    """One flat array of ``field`` over equal-size tables, and the size."""
    arrs = [getattr(t, field) for t in tables]
    return np.concatenate(arrs), len(arrs[0])


def windows(buf: np.ndarray) -> np.ndarray:
    """The little-endian u32 that starts at each byte of ``buf`` and one
    past its end (bytes past the end read as zeros): one gather reads up to
    25 bits at any bit position up to the end."""
    b = np.concatenate([buf, np.zeros(4, np.uint8)]).astype(np.uint32)
    return b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)


def read_bits(win: np.ndarray, pos: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The ``n`` bits (n <= 25) at bit positions ``pos`` of the byte string
    whose ``windows`` are ``win``."""
    return ((win[pos >> 3] >> (pos & 7).astype(np.uint32)).astype(np.int64)
            & ((np.int64(1) << n) - 1))


def encoder_start(enc, sym: np.ndarray) -> np.ndarray:
    """The state after ``new_first_symbol`` (fse.rs:210-218, in its
    floor + 1 form) for symbols ``sym`` of stacked encoders ``enc`` =
    (next, tt_bits, tt_find, row offset into next, row offset into tt)."""
    nxt, tt_bits, tt_find, noff, toff = enc
    bits = tt_bits[toff + sym]
    out = (bits >> 16) + 1
    value = ((out << 16) - bits) & U32
    return nxt[noff + (value >> out) + tt_find[toff + sym]]


def encoder_step(enc, value: np.ndarray, sym: np.ndarray):
    """One ``encode`` (fse.rs:227-239): (new value, bits pushed)."""
    nxt, tt_bits, tt_find, noff, toff = enc
    bits = tt_bits[toff + sym]
    out = ((bits + value) & U32) >> 16
    return nxt[noff + (value >> out) + tt_find[toff + sym]], out


def encoders(tables, rows: np.ndarray):
    """Stacked encode tables, each stream taking row ``rows`` of them."""
    nxt, size = stacked(tables, "next")
    tt_bits, _ = stacked(tables, "tt_bits")
    tt_find, _ = stacked(tables, "tt_find")
    return nxt, tt_bits, tt_find, rows * size, rows * 256


def bits_lanes(blocks: np.ndarray, tables, log2: int, k: int) -> np.ndarray:
    """Bits each lane of each block pushes: (B, k) int64. ``blocks`` is (B,
    n) uint8 with n = (R+1) k; ``tables`` one EncodeTable a block."""
    B, n = blocks.shape
    lanes = blocks.reshape(B, n // k, k).astype(np.int64)
    rows = np.repeat(np.arange(B), k)
    enc = encoders(tables, rows)
    value = encoder_start(enc, lanes[:, -1].reshape(-1))
    total = np.full(B * k, log2, np.int64)
    for r in range(n // k - 2, -1, -1):
        value, out = encoder_step(enc, value, lanes[:, r].reshape(-1))
        total += out
    return total.reshape(B, k)


def decode_lanes(win: np.ndarray, top: np.ndarray, base: np.ndarray, tables,
                 log2: int, k: int, n: int):
    """Decode the lanes of B blocks: lane j of block b is the bit stack of
    the bytes with ``windows`` ``win`` from bit ``base[b, j]`` up to bit
    ``top[b, j]``. Returns the
    (B, n) bytes and the (B, k) lanes that did not end exactly at their
    base (each such lane is wrong)."""
    B = top.shape[0]
    R = n // k - 1
    sym_t, size = stacked(tables, "symbol")
    nb_t, _ = stacked(tables, "num_bits")
    ns_t, _ = stacked(tables, "new_state")
    off = np.repeat(np.arange(B), k) * size
    pos = top.reshape(-1) - log2
    bad = pos < base.reshape(-1)
    pos = np.maximum(pos, 0)
    state = read_bits(win, pos, np.full(pos.shape, log2))
    out = np.empty((B, R + 1, k), np.uint8)
    for r in range(R):
        i = off + state
        nb = nb_t[i]
        pos = pos - nb
        bad |= pos < base.reshape(-1)
        pos = np.maximum(pos, 0)
        out[:, r] = sym_t[i].reshape(B, k)
        state = ns_t[i] + read_bits(win, pos, nb)
    out[:, R] = sym_t[off + state].reshape(B, k)
    bad |= pos != base.reshape(-1)
    return out.reshape(B, n), bad.reshape(B, k)


def bits_shared(block: np.ndarray, table, log2: int, k: int) -> int:
    """Bits of a shared-stream payload of ``block`` at ``k`` encoders:
    every push, the k final states and the marker bit."""
    n = len(block)
    src = block.astype(np.int64)
    enc = encoders([table], np.zeros(k, np.int64))
    value = np.zeros(k, np.int64)
    top = np.arange(n - k, n)
    value[top % k] = encoder_start(enc, src[top])
    total = 0
    hi = n - k - 1
    while hi >= 0:  # k consecutive bytes belong to k distinct encoders
        idx = np.arange(hi, max(hi - k, -1), -1)
        e = idx % k
        v, out = encoder_step((enc[0], enc[1], enc[2], enc[3][e], enc[4][e]),
                              value[e], src[idx])
        value[e] = v
        total += int(out.sum())
        hi -= k
    return total + k * log2 + 1


def decode_shared(payload: bytes, table, log2: int, k: int, n: int):
    """Decode a shared-stream payload into ``n`` bytes, as the reference's
    read-until-failure decoder does (lib.rs:187-248, k-way). Returns the
    bytes, or None where the framing or the length is wrong."""
    buf = np.frombuffer(payload, np.uint8)
    nz = np.flatnonzero(buf)
    if nz.size == 0:
        return None
    marker = int(nz[-1]) * 8 + int(buf[nz[-1]]).bit_length() - 1
    if len(buf) * 8 - marker > 8:
        return None
    win = windows(buf)
    pos = marker - log2 * (np.arange(k) + 1)
    if pos[-1] < 0:
        return None
    state = read_bits(win, pos, np.full(k, log2))
    at = marker - log2 * k
    out = []
    got = 0
    while True:
        nb = table.num_bits[state]
        cum = np.cumsum(nb)
        fail = np.flatnonzero(cum > at)
        take = k if fail.size == 0 else int(fail[0])
        if got + take > n:
            return None
        if take:
            p = at - cum[:take]
            out.append(table.symbol[state[:take]])
            state = state.copy()
            state[:take] = (table.new_state[state[:take]]
                            + read_bits(win, p, nb[:take]))
            at -= int(cum[take - 1])
            got += take
        if fail.size:
            order = (np.arange(k) + take) % k
            out.append(table.symbol[state[order]])
            got += k
            break
    if got != n:
        return None
    return np.concatenate(out).astype(np.uint8)

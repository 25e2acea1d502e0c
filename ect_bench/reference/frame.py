"""The plain reference's view of an ``FSET`` frame (FORMAT.md): what a frame
of given input bytes and knobs has to hold, block by block, and a check of
a frame against it.

``expected_blocks`` works out, from the input alone, each block's mode,
table, lane sizes and section length, as the container's rules set them
(RLE for a one-byte block, the per-lane layout where the block divides
into lanes, one shared stream otherwise, RAW where coding does not
shrink the block). ``check_frame`` parses the frame, compares its header,
block table, table headers and lane-size tables with that, and decodes
every checked block's payload back into bytes. It imports nothing of the
program it judges.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from . import coder
from .fse import (DecodeTable, EncodeTable, policy_table, read_header,
                  write_header)

MAGIC = b"FSET"
RAW, RLE, FSE, FSE_PL = 1, 2, 0, 3
F_SHARED, F_CRC, F_PACKED = 1, 2, 4
_HDR = struct.Struct("<BBHIQI")


@dataclass(frozen=True)
class Knobs:
    """The compress knobs a configuration states."""
    block_size: int
    k: int
    table_log: object  # int, "auto", "fast" or ["fast", eps]
    lanes: bool = True
    shared_table: bool = False
    checksum: bool = False
    bit_pack: bool = False


@dataclass
class Expected:
    """One block as the reference works it out."""
    mode: int
    length: int  # the section's length in bytes
    table: np.ndarray | None = None
    log2: int = 0
    k: int = 0  # streams of this block (the tail may have fewer)
    lane_bits: np.ndarray | None = None  # (k,), FSE_PL only
    size_cs: int = -1  # FSE_PL: the size table's length field (_size_table)


@dataclass
class Report:
    """What ``check_frame`` found."""
    blocks_checked: int = 0
    blocks_wrong: list = field(default_factory=list)  # (block, why)
    frame_wrong: list = field(default_factory=list)  # header-level faults

    @property
    def wrong(self) -> int:
        return len(self.blocks_wrong) + len(self.frame_wrong)


def pl_eligible(n: int, k: int, log2: int) -> bool:
    """Whether a block of n bytes takes per-lane streams at k lanes."""
    if k % 128 or n % k:
        return False
    q = n // k
    return q >= 2 and q * log2 < (1 << 16) and 5 <= log2 <= 15


def shared_table(data: np.ndarray, knobs: Knobs):
    """The frame's shared (table, log2), or None where the input gives
    none (one distinct byte, or a table the policy cannot make)."""
    counts = np.bincount(data, minlength=256).astype(np.int64)
    if np.count_nonzero(counts) <= 1:
        return None
    try:
        return policy_table(counts, len(data), knobs.table_log)
    except ValueError:
        return None


def _size_table(bits: np.ndarray, bit_pack: bool) -> int:
    """The length field of the lane-size table as written: -1 for the plain
    k u16s; with ``bit_pack`` the ``u16`` that leads it, the length of a
    k=2 shared stream (header and payload) over those bytes, or 0 where
    that would not shrink them and they follow as they are."""
    if not bit_pack:
        return -1
    st = bits.astype("<u2").tobytes()
    raw = np.frombuffer(st, np.uint8)
    counts = np.bincount(raw, minlength=256)
    if np.count_nonzero(counts) > 1:
        tab, l2 = policy_table(counts, len(raw), "auto")
        nbits = coder.bits_shared(raw, EncodeTable(tab, l2), l2, 2)
        cs = len(write_header(tab, l2)) + (nbits + 7) // 8
        if 0 < cs < min(len(st), 1 << 16):
            return cs
    return 0


def _size_table_len(cs: int, k: int) -> int:
    return 2 * k if cs < 0 else 2 + (cs or 2 * k)


def _coded(block: np.ndarray, knobs: Knobs, shared, tail: bool):
    """A block's table and layout before its bits are counted: an
    ``Expected`` whose ``length`` is still to be set (mode FSE or FSE_PL),
    or the final ``Expected`` of an RLE or RAW block."""
    n = len(block)
    counts = np.bincount(block, minlength=256).astype(np.int64)
    if n > 1 and np.count_nonzero(counts) == 1:
        return Expected(RLE, 1)
    if tail and n < 8:
        return Expected(RAW, n)
    k = min(knobs.k, n)
    try:
        tab, l2 = shared if shared is not None else policy_table(
            counts, n, knobs.table_log)
    except ValueError:
        return Expected(RAW, n)
    hdr = 0 if shared is not None else len(write_header(tab, l2))
    mode = FSE_PL if knobs.lanes and pl_eligible(n, k, l2) else FSE
    return Expected(mode, hdr, tab, l2, k)


def expected_blocks(blocks: list, knobs: Knobs, shared, tails: list) -> list:
    """The reference's ``Expected`` for each block of raw bytes: its table,
    and the bits its encoders push (the per-lane blocks of one table log and
    length counted together), which set its lane sizes, its section's
    length and whether coding won over RAW."""
    out = [_coded(b, knobs, shared, t) for b, t in zip(blocks, tails)]
    groups: dict = {}
    for j, e in enumerate(out):
        if e.mode == FSE_PL:
            groups.setdefault((e.log2, len(blocks[j]), e.k), []).append(j)
        elif e.mode == FSE:
            nbits = coder.bits_shared(blocks[j], EncodeTable(e.table, e.log2),
                                      e.log2, e.k)
            e.length += (nbits + 7) // 8
    for (l2, n, k), js in groups.items():
        bits = coder.bits_lanes(np.stack([blocks[j] for j in js]),
                                [EncodeTable(out[j].table, l2) for j in js],
                                l2, k)
        for j, b in zip(js, bits):
            e = out[j]
            e.lane_bits = b
            e.size_cs = _size_table(b, knobs.bit_pack)
            body = (int(b.sum()) + 7) // 8 if knobs.bit_pack \
                else int(((b + 7) // 8).sum())
            e.length += _size_table_len(e.size_cs, k) + body
    return [e if e.mode in (RAW, RLE) or e.length < len(b)
            else Expected(RAW, len(b)) for e, b in zip(out, blocks)]


@dataclass
class Parsed:
    k: int
    block_size: int
    total_len: int
    n_blocks: int
    flags: int
    shared_hdr: bytes
    modes: np.ndarray
    lens: np.ndarray
    offs: np.ndarray
    crcs: np.ndarray | None


def parse(frame: bytes) -> Parsed:
    """The frame's header, shared table header and block table."""
    if len(frame) < 4 + _HDR.size or frame[:4] != MAGIC:
        raise ValueError("not an FSET frame")
    version, flags, k, bs, total, nb = _HDR.unpack_from(frame, 4)
    if version != 2 or flags & ~7 or k < 1 or bs < 1:
        raise ValueError("bad frame header")
    if nb != -(-total // bs):
        raise ValueError("block count does not match the length")
    off = 4 + _HDR.size
    shared_hdr = b""
    if flags & F_SHARED:
        (h,) = struct.unpack_from("<H", frame, off)
        shared_hdr = frame[off + 2: off + 2 + h]
        off += 2 + h
    ent = np.frombuffer(frame, "<u4", count=nb, offset=off).astype(np.int64)
    off += 4 * nb
    crcs = None
    if flags & F_CRC:
        crcs = np.frombuffer(frame, "<u4", count=nb, offset=off).copy()
        off += 4 * nb
    lens = ent & ((1 << 30) - 1)
    offs = off + np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    if off + int(lens.sum()) != len(frame):
        raise ValueError("sections do not fill the frame")
    return Parsed(k, bs, total, nb, flags, shared_hdr, ent >> 30, lens, offs,
                  crcs)


def check_frame(frame: bytes, data: np.ndarray, knobs: Knobs,
                blocks=None) -> Report:
    """Hold ``frame`` against the reference's reading of ``data`` under
    ``knobs``: every block, or the block indices ``blocks``. A frame that
    does not parse is one frame-level fault."""
    rep = Report()
    try:
        pf = parse(frame)
    except (ValueError, struct.error) as e:
        rep.frame_wrong.append(f"parse: {e}")
        return rep
    bs, n_total = knobs.block_size, len(data)
    want_flags = ((F_SHARED if knobs.shared_table else 0)
                  | (F_CRC if knobs.checksum else 0)
                  | (F_PACKED if knobs.bit_pack else 0))
    shared = shared_table(data, knobs) if knobs.shared_table else None
    if knobs.shared_table and shared is None:
        want_flags &= ~F_SHARED
    head = (pf.k, pf.block_size, pf.total_len, pf.flags)
    if head != (knobs.k, bs, n_total, want_flags):
        rep.frame_wrong.append(f"header {head}")
        return rep
    if shared is not None:
        if pf.shared_hdr != write_header(*shared):
            rep.frame_wrong.append("shared table header")
    ids = range(pf.n_blocks) if blocks is None else sorted(set(blocks))
    pl = {}  # (log2, n, k) -> [(block, expected, lanes offset)]
    blocks = [data[i * bs: min(i * bs + bs, n_total)] for i in ids]
    want = expected_blocks(blocks, knobs, shared,
                           [i * bs + bs > n_total for i in ids])
    for i, block, e in zip(ids, blocks, want):
        rep.blocks_checked += 1
        why = _check_section(frame, pf, i, block, e, shared, pl, knobs)
        if why:
            rep.blocks_wrong.append((i, why))
        if pf.crcs is not None and int(pf.crcs[i]) != zlib.crc32(block):
            rep.blocks_wrong.append((i, "crc"))
    for (l2, n, k), items in pl.items():
        _decode_pl_group(frame, data, items, l2, n, k, knobs, rep)
    return rep


def _check_section(frame, pf, i, block, e, shared, pl, knobs):
    """Compare block i's entry and section with ``e``; queue a per-lane
    block for its group's decode. Returns what is wrong, or ''."""
    mode, length = int(pf.modes[i]), int(pf.lens[i])
    if (mode, length) != (e.mode, e.length):
        return f"entry mode {mode} length {length}, want {e.mode} {e.length}"
    sec = frame[int(pf.offs[i]): int(pf.offs[i]) + length]
    if mode == RAW:
        return "" if sec == block.tobytes() else "raw bytes"
    if mode == RLE:
        return "" if sec[0] == block[0] else "rle byte"
    at = 0
    if shared is None:
        try:
            tab, l2, at = read_header(sec)
        except ValueError as err:
            return f"table header: {err}"
        if l2 != e.log2 or not np.array_equal(tab, e.table):
            return f"table (log {l2}, want {e.log2})"
        if sec[:at] != write_header(e.table, e.log2):
            return "table header bytes"
    if mode == FSE:
        got = coder.decode_shared(sec[at:], DecodeTable(e.table, e.log2),
                                  e.log2, e.k, len(block))
        if got is None:
            return "shared stream framing"
        return "" if np.array_equal(got, block) else "shared stream bytes"
    sizes, body = _lane_sizes(sec[at:], e)
    if sizes is None:
        return "lane size table"
    if not np.array_equal(sizes, e.lane_bits):
        return "lane sizes"
    off = int(pf.offs[i]) + length - body
    pl.setdefault((e.log2, len(block), e.k), []).append((i, e, off))
    return ""


def _lane_sizes(sec: bytes, e: Expected):
    """(lane bit sizes, bytes of lane streams) from the front of a per-lane
    section, or (None, 0) where its size table is not the expected one's
    form or does not decode."""
    k = e.k
    if e.size_cs < 0:
        if len(sec) < 2 * k:
            return None, 0
        return (np.frombuffer(sec[: 2 * k], "<u2").astype(np.int64),
                len(sec) - 2 * k)
    (cs,) = struct.unpack_from("<H", sec)
    if cs != e.size_cs:
        return None, 0
    if cs == 0:
        st = sec[2: 2 + 2 * k]
    else:
        try:
            tab, l2, at = read_header(sec[2: 2 + cs])
        except ValueError:
            return None, 0
        st = coder.decode_shared(sec[2 + at: 2 + cs], DecodeTable(tab, l2),
                                 l2, 2, 2 * k)
        if st is None:
            return None, 0
        st = st.tobytes()
    if len(st) != 2 * k:
        return None, 0
    return (np.frombuffer(st, "<u2").astype(np.int64),
            len(sec) - _size_table_len(cs, k))


def _decode_pl_group(frame, data, items, l2, n, k, knobs, rep):
    """Decode one (table log, length, k) group of per-lane blocks at once
    and compare every block with the input. ``items`` are (block,
    Expected, offset of its lane streams in the frame)."""
    B = len(items)
    bits = np.stack([e.lane_bits for _, e, _ in items])
    nbytes = (bits.sum(axis=1) + 7) // 8 if knobs.bit_pack \
        else ((bits + 7) // 8).sum(axis=1)
    # the group's lane streams, gathered into one buffer
    buf = np.concatenate([np.frombuffer(frame, np.uint8, count=int(c), offset=o)
                          for (_, _, o), c in zip(items, nbytes)])
    at = np.concatenate([[0], np.cumsum(nbytes)[:-1]]).astype(np.int64)
    if knobs.bit_pack:
        starts = np.cumsum(bits, axis=1) - bits
    else:
        starts = 8 * (np.cumsum((bits + 7) // 8, axis=1) - (bits + 7) // 8)
    base = 8 * at[:, None] + starts
    tables = [DecodeTable(e.table, e.log2) for _, e, _ in items]
    top = base + bits
    win = coder.windows(buf)
    got, bad = coder.decode_lanes(win, top, base, tables, l2, k, n)
    # the dead bits above each lane's top (byte-aligned lanes), or above the
    # last lane's (bit-packed), are zero
    if knobs.bit_pack:
        bad[:, -1] |= coder.read_bits(win, top[:, -1], (-top[:, -1]) % 8) != 0
    else:
        bad |= coder.read_bits(win, top, (-bits) % 8) != 0
    for j, (i, _, _) in enumerate(items):
        lo = i * knobs.block_size
        if bad[j].any():
            rep.blocks_wrong.append((i, "lane framing"))
        elif not np.array_equal(got[j], data[lo: lo + n]):
            rep.blocks_wrong.append((i, "lane bytes"))

"""Block-container codec (format: FORMAT.md), PyTorch + CUDA.

Counterpart of ``entropy_coders_tpu/frame.py``: it writes and reads the same
``FSET`` frames, byte for byte. Data splits into fixed-size blocks; each
block is coded independently (per-lane streams, MODE_FSE_PL; the
shared-stream k-way interleave, MODE_FSE; or the RAW/RLE escapes).

Pipeline per frame:
  host split -> one h2d of the full blocks -> device histogram (D6) -> host
  normalize (``normalize``) + header write -> table build (``ops.tables``
  on the card, or ``native`` on the host: ``host_tables``) -> per-lane
  encode kernel (B2) -> lane merge (``ops.device_repack`` on a CUDA device:
  only the payload bytes come back; the C++ merge for the CPU) -> frame
  assembly. Decode mirrors it: the span of the frame that holds the
  per-lane payloads goes to the card once, the lane split (D2) and the
  per-lane decode kernel (B1) run there, and the blocks are written into
  one buffer: the caller's ``out`` over a block-aligned range, else one
  fresh ``bytes``, returned whole or, for an unaligned range, sliced. On
  frames with crcs the blocks are checksummed where they lie (``ops.crc``):
  each share's full blocks behind the last encode dispatch, each decoded
  per-lane chunk behind B1; the host writes or compares 4 bytes a block,
  and checksums only the blocks it holds alone (a compress's ragged tail;
  RAW, RLE and MODE_FSE blocks on decompress). Each public call is one
  ``torch.profiler`` range (``ect.compress``, ``ect.decompress``) from its
  first line until its locals are released; its stages are named ranges
  inside it (``ect.<op>.*``: the share ranges of ``mesh``, a frame's crc
  pass ``ect.<op>.crc``, each bit-packed block's lane-size table
  ``ect.<op>.size_table``), so a trace splits the host's time by stage.
  The calls count themselves, the bytes of the fresh host buffers they
  make, the bytes they checksum and the size tables they code
  (``utils.profiling.counters``).

``device`` selects where the block work runs. It defaults to ``"cuda"`` and
raises when CUDA is unavailable; ``device="cpu"`` runs the kernels' plain
PyTorch versions. ``lanes=None`` resolves to the per-lane path on CUDA (the
JAX package resolves it to its TPU backend). The per-lane path works in
chunks of ~64 MiB of raw bytes and pipelines them as the JAX package does
(``lazy=True``): every chunk's kernel is dispatched before the first is
drained, so the host merge (encode) or write-back (decode) of chunk i
overlaps the device work and copies of the chunks after it; every chunk's
output is on the card at once.

``sharding`` (``parallel.block_sharding(mesh)``, the counterpart of the JAX
package's ``NamedSharding`` over the block axis) spreads the block work over
``sharding.mesh``. Every stage goes through ``mesh``'s one share loop, a
share on its own device, unpadded: compress's h2d and histograms, then a
table-log group's encode at a time; decompress dispatches every share of
every group, MODE_FSE then per-lane, before the first drain. A dispatch
returns its share's handle (``_Queued``, ``_FseEncoded``, or the d2h's
``Later``) and its drain takes it. The unsharded call is the one-share
case; ``sharding`` changes no byte of the frame.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import types
import zlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function as _stage

from . import mesh as M
from . import native
from .constants import TABLE_LOG_DEFAULT, TABLE_LOG_MAX, TABLE_LOG_MIN
from .normalize import normalize_batch
from .ops import device_repack as DR
from .ops import pl_coder as PL
from .ops.coder import blocks_to_syms, decode_core, encode_core, encode_layout
from .ops.crc import crc32_blocks
from .ops.histogram import histogram_blocks
from .ops.unsigned import d2h, launched, to_device
from .utils.profiling import count as _count

MAGIC = b"FSET"
VERSION = 2
FLAG_SHARED = 1
FLAG_CRC = 2  # per-block crc32 table present (integrity checking)
FLAG_PACKED = 4  # MODE_FSE_PL lane streams bit-packed (no dead bits)

MODE_FSE = 0
MODE_RAW = 1
MODE_RLE = 2
MODE_FSE_PL = 3  # per-lane streams (ops.pl_coder kernels)

DEFAULT_BLOCK_SIZE = 1 << 17
DEFAULT_K = 1024

# Default table-log policy of the per-lane path, the JAX package's
# ("fast", 0.0025) (frame.py PL_TABLE_LOG): it changes the frame's bytes, so
# the port keeps it until a measurement on the card decides otherwise.
PL_TABLE_LOG = ("fast", 0.0025)

_CHUNK_RAW = 64 << 20  # raw bytes per kernel call on the per-lane path

# Where the lane repack of the per-lane path runs. None: on the card for a
# CUDA device (``ops.device_repack``, kernels D1/D2) and in the C++ host
# library for the CPU. True/False force the device route (through the plain
# versions on the CPU) or the C++ route: a private switch for tests and
# in-turn measurements, not a user knob. Both write the same bytes.
_DEVICE_REPACK: bool | None = None


def _device_repack(dev: torch.device) -> bool:
    return dev.type == "cuda" if _DEVICE_REPACK is None else _DEVICE_REPACK


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _call_range(op: str):
    """Decorate a public entry: its whole call is the range ``ect.<op>``,
    which holds every ``ect.<op>.*`` stage and the release of the call's
    locals."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _stage(f"ect.{op}"):
                return fn(*args, **kwargs)
        return call
    return wrap


# --- compress ----------------------------------------------------------------


def _pl_eligible(block_size: int, k: int, log2: int) -> bool:
    """Whether a full block can take the per-lane-stream path
    (MODE_FSE_PL): k a multiple of 128, block divisible into >= 2 bytes per
    lane, worst-case lane bit count within the u16 size field, and a
    reference table log (5..15)."""
    if k % 128 != 0 or block_size % k != 0:
        return False
    q = block_size // k
    if q < 2 or (q - 1) * log2 + log2 >= (1 << 16):
        return False
    return 5 <= log2 <= 15


def resolve_shared_table(counts_all, total_len: int, table_log, lanes: bool):
    """Resolve the shared-table decision from exact global counts.

    Returns ``(norm_table (256,) int32, log2)``, or ``None`` when the input
    degrades to per-block RAW/RLE modes (degenerate <= 1-symbol data, or an
    un-normalizable total). ``table_log`` of ``None`` resolves to the
    default of the ``lanes`` path, as ``compress`` does."""
    if table_log is None:
        table_log = PL_TABLE_LOG if lanes else TABLE_LOG_DEFAULT
    counts_all = np.asarray(counts_all)
    if np.count_nonzero(counts_all) <= 1:
        return None
    try:
        tables, log2s = normalize_batch(counts_all[None], total_len,
                                        table_log)
    except ValueError:
        return None
    return tables[0], int(log2s[0])


@_call_range("compress")
def compress(
    data,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    k: int = DEFAULT_K,
    shared_table: bool = False,
    shared_hist=None,
    table_log: int | str | tuple | None = None,
    lanes: bool | None = None,
    checksum: bool = False,
    bit_pack: bool = False,
    device=None,
    sharding=None,
) -> bytes:
    """Compress ``data`` into a container frame (FORMAT.md), byte-identical
    to ``entropy_coders_tpu.frame.compress`` with the same knobs.

    ``lanes`` selects the per-lane-stream block mode (MODE_FSE_PL): None =
    on CUDA devices, True/False to force. ``table_log`` defaults to
    PL_TABLE_LOG on the lanes path and TABLE_LOG_DEFAULT otherwise; an int,
    ``"auto"``, ``"fast"`` or ``("fast", eps)`` as in
    ``normalize.normalize_batch``. ``checksum`` appends a
    per-block crc32 table, verified on decompress. ``bit_pack``
    (FLAG_PACKED) packs the lane streams at bit granularity and
    FSE-compresses the lane-size table. ``shared_hist`` (with
    ``shared_table=True``) supplies a precomputed ``(norm_table, log2)``
    pair as the shared table. ``device`` is where the block work runs
    (default ``"cuda"``, which raises when CUDA is unavailable).
    ``sharding`` spreads the block work over ``sharding.mesh`` (module
    docstring); the ragged tail block runs on the mesh's first device."""
    _count("calls.compress")
    mesh = M.of_call(device, sharding)
    if lanes is None:
        lanes = mesh[0].type == "cuda"
    if table_log is None:
        table_log = PL_TABLE_LOG if lanes else TABLE_LOG_DEFAULT
    with _stage("ect.compress.input"):
        if isinstance(data, np.ndarray):
            data = np.asarray(data, np.uint8)
        else:
            data = np.frombuffer(bytearray(data), np.uint8)
            _count("host_bytes.compress.input", data.nbytes)
    if block_size < 16:
        raise ValueError("block_size must be >= 16")
    if k < 1 or k > min(block_size, 0xFFFF):
        raise ValueError(f"k={k} must be in [1, min(block_size="
                         f"{block_size}, 65535)]")
    total_len = len(data)
    if total_len == 0:
        return _frame_header(0, k, block_size, 0, False, checksum, bit_pack)
    n_blocks = _cdiv(total_len, block_size)

    full = total_len // block_size
    sections: list[bytes] = [b""] * n_blocks
    modes = np.full(n_blocks, MODE_FSE, np.int32)

    nsym = blocks = None
    # the full blocks' shares, each one's device copy and its crcs later
    shares, placed, crc_pending = [], [], []
    if full:
        blocks = data[: full * block_size].reshape(full, block_size)
        shares = M.shares(full, mesh)
        # one h2d per share of the mesh (one share without a sharding): the
        # device copies feed both the histogram and the lane encode kernel
        with _stage("ect.compress.h2d"):
            pinned = M.spans_cards(mesh)
            placed = M.dispatch("compress", shares, lambda s: to_device(
                blocks[s.lo: s.hi], s.device, non_blocking=pinned))
        with _stage("ect.compress.histogram"):
            # every share's D6 and the d2h of its counts are queued behind
            # that share's h2d before the first is waited for: nothing here
            # waits for a card until the last share's work is queued
            pending = M.dispatch("compress", shares, lambda s, t: d2h(
                [histogram_blocks(t)]), placed)
            counts = np.concatenate(M.drain("compress", shares, pending,
                                            lambda s, later: later.get()[0]))
        # single-symbol blocks can't be FSE-coded (the reference's
        # normalization rejects table_len == 1); they take the RLE escape
        nsym = (counts != 0).sum(axis=1)

    shared_hdr = b""
    s_shared = None
    if shared_table:
        if shared_hist is not None:
            s_shared = (np.asarray(shared_hist[0], np.int32),
                        int(shared_hist[1]))
        else:
            # the whole input's counts, int64 (exact past u32 for > 4 GiB
            # inputs): the full blocks' device counts and the tail's
            with _stage("ect.compress.shared_table"):
                counts_all = np.bincount(data[full * block_size:],
                                         minlength=256)
                if full:
                    counts_all += counts.sum(axis=0)
                s_shared = resolve_shared_table(counts_all, total_len,
                                                table_log, lanes)
        if s_shared is None:
            shared_table = False  # degenerate / un-normalizable input:
        else:                     # blocks degrade to RAW/RLE
            shared_hdr = _write_header(*s_shared)

    if full:
        codable = np.flatnonzero(nsym > 1)
        drain_last = None
        if codable.size:
            if shared_table:
                norm_tables = np.repeat(s_shared[0][None], codable.size,
                                        axis=0)
                log2_arr = np.full(codable.size, s_shared[1], np.int64)
            else:
                with _stage("ect.compress.normalize"):
                    norm_tables, log2_arr = normalize_batch(
                        counts[codable], block_size, table_log)
            drain_last = _encode_group(
                blocks, norm_tables, log2_arr, k, shared_table, sections,
                modes, codable, mesh, lanes=lanes,
                placed=list(zip(shares, placed)), bit_pack=bit_pack)
        if checksum:
            # each share's crc kernel over its device copy, behind the last
            # group's encode dispatch and before its first drain (nothing
            # waits behind it on the card), and the d2h of its 4 bytes a
            # block
            crc_pending = M.dispatch("compress", shares, lambda s, t:
                                     d2h([crc32_blocks(t)]), placed)
        if drain_last is not None:
            drain_last()

    if full * block_size < total_len:  # ragged tail block
        with _stage("ect.compress.tail"):
            _encode_tail(data[full * block_size:], k, table_log,
                         shared_table, s_shared, sections, modes,
                         n_blocks - 1, mesh[0], lanes=lanes,
                         bit_pack=bit_pack)

    with _stage("ect.compress.frame"):
        # RAW/RLE escapes where FSE did not win. Constant-block detection for
        # full blocks comes free from the device histogram (nsym == 1).
        raw_lens = [min(block_size, total_len - i * block_size)
                    for i in range(n_blocks)]
        for i in range(n_blocks):
            rl = raw_lens[i]
            o = i * block_size
            if modes[i] in (MODE_FSE, MODE_FSE_PL) and len(sections[i]) >= rl:
                modes[i] = MODE_RAW
                sections[i] = data[o: o + rl].tobytes()
                _count("host_bytes.compress.escapes", rl)
            if i < full:
                is_const = bool(nsym[i] == 1)
            else:
                is_const = rl > 1 and bool((data[o: o + rl] == data[o]).all())
            if modes[i] != MODE_RLE and rl > 1 and is_const:
                modes[i] = MODE_RLE
                sections[i] = bytes([int(data[o])])
                _count("host_bytes.compress.escapes", 1)

        parts = [_frame_header(total_len, k, block_size, n_blocks,
                               shared_table, checksum, bit_pack)]
        if shared_table:
            parts.append(struct.pack("<H", len(shared_hdr)) + shared_hdr)
        entries = (modes.astype(np.uint32) << 30) | np.array(
            [len(s) for s in sections], np.uint32)
        parts.append(entries.astype("<u4").tobytes())
        if checksum:
            with _stage("ect.compress.crc"):
                # the full blocks' crcs from the card; the ragged tail
                # block, never a row there, on the host
                crcs = np.empty(n_blocks, np.uint32)
                for s, later in zip(shares, crc_pending):
                    crcs[s.lo: s.hi] = later.get()[0]
                for i in range(full, n_blocks):
                    crcs[i] = zlib.crc32(data[i * block_size:][:raw_lens[i]])
                parts.append(crcs.astype("<u4").tobytes())
            _count("crc.compress", total_len)
            if full:
                _count("crc.compress.device", full * block_size)
        parts.extend(sections)
        out = b"".join(parts)
        _count("host_bytes.compress.frame", len(out))
    with _stage("ect.compress.release"):
        # the call's host buffers go inside its range, not after it
        del data, blocks, placed, sections, parts, crc_pending
    return out


def _tl(table) -> int:
    nz = np.flatnonzero(table)
    return int(nz[-1]) + 1 if nz.size else 1


def _write_header(table, log2: int) -> bytes:
    """Zstd-format histogram header bytes (C++ writer)."""
    return native.write_header(np.asarray(table, np.int32), int(log2),
                               _tl(table))


def _read_block_header(sec: bytes):
    """Parse a histogram header off the front of a block section. Returns
    (table (256,) int32, log2, payload); raises ValueError on a malformed
    header."""
    table, log2, _tl_, n = native.read_header(sec)
    return table, log2, sec[n:]


def _pack_size_table(st: bytes) -> bytes:
    """FLAG_PACKED lane-size table: ``u16 cs_len`` + either the
    FSE-compressed table (cs_len > 0; reference k=2 frame over the raw u16
    LE bytes) or the raw table (cs_len == 0, incompressible or degenerate
    fallback). Each call is the range ``ect.compress.size_table`` and
    counts ``size_table.compress.coded`` or ``.raw``."""
    with _stage("ect.compress.size_table"):
        try:
            cs = native.compress(st, k=2)
            if 0 < len(cs) < min(len(st), 1 << 16):
                _count("size_table.compress.coded")
                return struct.pack("<H", len(cs)) + cs
        except ValueError:
            pass  # degenerate distribution: fall through to raw
        _count("size_table.compress.raw")
        return struct.pack("<H", 0) + st


def _unpack_size_table(sec: bytes, k: int) -> tuple[np.ndarray, bytes]:
    """Inverse of _pack_size_table: returns (sizes (k,) int32, rest). Each
    call is the range ``ect.decompress.size_table`` and counts
    ``size_table.decompress.coded`` or ``.raw``."""
    with _stage("ect.decompress.size_table"):
        if len(sec) < 2:
            raise ValueError("truncated lane size table")
        (cs_len,) = struct.unpack_from("<H", sec)
        if cs_len == 0:
            if len(sec) < 2 + 2 * k:
                raise ValueError("truncated lane size table")
            st = sec[2: 2 + 2 * k]
            _count("size_table.decompress.raw")
            return (np.frombuffer(st, "<u2").astype(np.int32),
                    sec[2 + 2 * k:])
        if len(sec) < 2 + cs_len:
            raise ValueError("truncated lane size table")
        # max_out bounds a crafted low-entropy stream: the expected output
        # is exactly 2k bytes, anything bigger is corrupt
        st = native.decompress(sec[2: 2 + cs_len], k=2, max_out=2 * k + 8)
        if len(st) != 2 * k:
            raise ValueError("size table length mismatch")
        _count("size_table.decompress.coded")
        return np.frombuffer(st, "<u2").astype(np.int32), sec[2 + cs_len:]


def _frame_header(total_len, k, block_size, n_blocks, shared,
                  crc=False, packed=False) -> bytes:
    flags = ((FLAG_SHARED if shared else 0) | (FLAG_CRC if crc else 0)
             | (FLAG_PACKED if packed else 0))
    return MAGIC + struct.pack("<BBHIQI", VERSION, flags, k, block_size,
                               total_len, n_blocks)


def _encode_dispatch_pl(blocks_dev, norm_tables, l2, k, bit_pack=False):
    """Queue the per-lane-stream (MODE_FSE_PL) encode of equal-size blocks
    sharing one table log, from the device-resident (B, n) uint8
    ``blocks_dev``: the group's encode tables built once (D3 on CUDA), then
    B2 on CUDA, its plain version on CPU, ~64 MiB of raw bytes per call,
    each call on its rows of the tables, and the lane merge (D1 on the card
    behind B2; on the C++ route, ``_DEVICE_REPACK``, the merge runs at the
    drain). Returns the ``_Queued`` that ``_encode_drain_pl`` takes: the
    tables, 2^(L+1) + 2 KiB a block, are held until the group's last chunk
    is collected."""
    B, n = blocks_dev.shape
    R = n // k - 1
    W = PL.encode_w_bound(R, int(l2))
    on_device = _device_repack(blocks_dev.device)
    chunk = max(1, _cdiv(_CHUNK_RAW, n))

    def launch(j0):
        rows = slice(j0, j0 + chunk)
        own = PL.table_rows(tables, j0, j0 + chunk)
        if on_device:
            # the merge is queued behind B2 on the card; only the payload
            # bytes and the sizes come back
            return DR.encode_lanes_merged(
                blocks_dev[rows], norm_tables[rows], k=k, L=int(l2), W=W,
                pack_bits=bit_pack, tables=own)
        return PL.encode_lanes_norm(blocks_dev[rows], norm_tables[rows], k=k,
                                    L=int(l2), W=W, lazy=True, tables=own)

    # every chunk's kernels are dispatched before the first is drained
    # (entropy_coders_tpu/frame.py:477-488): the host's merge (on its
    # route) and section assembly of one chunk overlap the device work of
    # the chunks after it
    with _stage("ect.compress.dispatch"):
        tables = PL.tables_from_norm(norm_tables, int(l2), blocks_dev.device,
                                     half="encode")
        chunks = [(j0, launch(j0)) for j0 in range(0, B, chunk)]
    return _Queued(chunks, tables, on_device)


def _encode_drain_pl(dispatched, norm_tables, l2, shared_table, sections,
                     modes, block_ids, bit_pack=False):
    """Collect the chunks ``_encode_dispatch_pl`` queued, in order, and
    assemble their sections on the host: row j of ``norm_tables`` codes
    block ``block_ids[j]`` into ``sections[block_ids[j]]``."""
    for j0, collect in dispatched.chunks:
        with _stage("ect.compress.collect"):
            got = collect()
        if dispatched.on_device:
            flat, offs, szs = got
            payloads = [flat[offs[jj]: offs[jj + 1]]
                        for jj in range(len(szs))]
        else:
            words, szs = got
            with _stage("ect.compress.merge_cpp"):
                payloads = PL.lane_merge_batch(words, szs, pack_bits=bit_pack)
                # the C++ merge writes the group into one buffer (8 bytes
                # of slack a block bit-packed), then copies out each block's
                _count("host_bytes.compress.merge",
                       2 * sum(len(p) for p in payloads)
                       + (8 * len(payloads) if bit_pack else 0))
        with _stage("ect.compress.assemble"):
            for jj, payload in enumerate(payloads):
                j = j0 + jj
                st = szs[jj].astype("<u2").tobytes()
                # FLAG_PACKED also FSE-compresses the lane-size table (2
                # bytes/lane, up to 12% of small-k blocks)
                parts = [_pack_size_table(st) if bit_pack else st, payload]
                if not shared_table:
                    parts.insert(0, _write_header(norm_tables[j], int(l2)))
                sections[block_ids[j]] = b"".join(parts)
                _count("host_bytes.compress.sections",
                       len(sections[block_ids[j]]))
                modes[block_ids[j]] = MODE_FSE_PL


def _rows_on(dev, ids, blocks, placed):
    """Blocks ``ids`` (sorted) of the host array ``blocks`` as one tensor on
    ``dev``: a slice or gather of a device copy in ``placed`` ((share,
    tensor) pairs) that holds them all, else one h2d."""
    for s, t in placed:
        if t.device == dev and s.lo <= ids[0] and ids[-1] < s.hi:
            if ids[-1] - ids[0] + 1 == len(ids):
                return t[ids[0] - s.lo: ids[-1] - s.lo + 1]
            # a blocking copy would wait for the shares queued on ``dev``
            return t[to_device(ids - s.lo, dev, non_blocking=True)]
    rows = blocks[ids]
    _count("host_bytes.compress.gather", rows.nbytes)
    return torch.from_numpy(rows).to(dev)


def _encode_group(blocks, norm_tables, log2_arr, k, shared_table, sections,
                  modes, block_ids, mesh, lanes=False, placed=(),
                  bit_pack=False):
    """Encode equal-size blocks, grouped by effective table log: row j of
    ``norm_tables``/``log2_arr`` codes block ``block_ids[j]`` of the host
    array ``blocks`` into ``sections[block_ids[j]]``. Each group splits into
    one contiguous share per entry of ``mesh``. With ``lanes``, eligible
    groups take the per-lane path (reading the device copies in ``placed``,
    (share, tensor) pairs, where they hold the share); the others take the
    shared-stream path (ops.coder). The groups run in turn, as in the JAX
    package. Returns the last group's drain, not yet run: the caller may
    queue more work behind that group's encode before calling it."""
    n = blocks.shape[1]
    layout = None  # shared-stream emission layout, built on first use
    groups = np.unique(log2_arr)
    for l2 in map(int, groups):
        rows = np.flatnonzero(log2_arr == l2)
        shares = M.shares(len(rows), mesh)
        lane = lanes and _pl_eligible(n, k, l2)
        if not lane and layout is None:
            layout = _FseLayout(n, k)

        def dispatch(s):
            r = rows[s.lo: s.hi]
            if lane:
                return _encode_dispatch_pl(
                    _rows_on(s.device, block_ids[r], blocks, placed),
                    norm_tables[r], l2, k, bit_pack=bit_pack)
            host = blocks[block_ids[r]]
            _count("host_bytes.compress.gather", host.nbytes)
            return _encode_dispatch_fse(host, norm_tables[r], l2, k,
                                        s.device, layout)

        def drain(s, queued):
            r = rows[s.lo: s.hi]
            if lane:
                _encode_drain_pl(queued, norm_tables[r], l2, shared_table,
                                 sections, modes, block_ids[r],
                                 bit_pack=bit_pack)
            else:
                _encode_drain_fse(queued, norm_tables[r], l2, shared_table,
                                  sections, block_ids[r])

        # on a MODE_FSE group every share's bit counts are read and the d2h
        # of its words queued before the first share's words are waited
        # for, so that one share's assembly overlaps the copies of the
        # shares after it
        last = functools.partial(
            M.drain, "compress", shares, M.dispatch("compress", shares,
                                                    dispatch), drain,
            ready=None if lane else "ect.compress.fse_collect")
        if l2 == groups[-1]:
            return last
        last()


class _FseLayout:
    """The shared-stream emission layout of blocks of raw length n at k
    lanes (``ops.coder.encode_layout``: m, R, W and the masks ``valid``
    and ``finish_slots``), and the two masks on each device that asks for
    them: uploaded once a device, not once a share."""

    def __init__(self, n: int, k: int):
        self.m, self.R, self.valid, self.finish_slots, self.W = \
            encode_layout(n, k)
        self._on: dict = {}

    def on(self, dev: torch.device):
        """(valid, finish_slots) on ``dev``."""
        if dev not in self._on:
            self._on[dev] = tuple(to_device(a, dev, non_blocking=True)
                                  for a in (self.valid, self.finish_slots))
        return self._on[dev]


class _Queued(NamedTuple):
    """One share's per-lane encode or decode as its dispatch queued it:
    ``chunks``, (first row, ``collect``) in row order; the group's
    ``tables``, held until the last is collected; the encode's merge on the
    card or not (``on_device``); the decode's crcs as the device computed
    them, block -> crc, filled by its drain."""
    chunks: list
    tables: object = None
    on_device: bool = False
    crcs: dict | None = None

    def ready(self) -> None:
        """Nothing: every copy of the share was queued at dispatch."""


class _FseEncoded:
    """One share's shared-stream encode as ``_encode_dispatch_fse`` queued
    it: D4's (B, W) words on the card and the d2h of the streams' bit
    counts. ``ready`` waits for the bit counts (``total_bits``, host numpy)
    and queues the d2h of only the words the longest stream fills, behind
    this share's D4 and not behind the kernels queued after it; ``words``,
    after it, waits for that copy."""

    def __init__(self, words: torch.Tensor, total_bits: torch.Tensor):
        self._words = words
        self._after = launched(words.device)
        self._bits = d2h([total_bits], self._after)
        self._get = None
        self.total_bits = None

    def ready(self) -> None:
        if self._get is None:
            (self.total_bits,) = self._bits.get()
            used = _cdiv(int(self.total_bits.max()), 32)
            self._get = d2h([self._words[:, :used]], self._after, 1)
            self._words = None

    def words(self) -> np.ndarray:
        return self._get.get()[0]


def _encode_dispatch_fse(blocks, norm_tables, l2, k, dev, layout):
    """Queue the shared-stream (MODE_FSE) encode of the host blocks (B, n)
    sharing table log ``l2`` on ``dev``, waiting for nothing on the card:
    the symbols laid out on the host (``blocks_to_syms``), their h2d from
    pinned staging (a pageable copy would wait for the shares queued on
    ``dev`` before it), the encode tables where the per-lane groups build
    theirs (``PL.tables_from_norm``: kernel D3 on CUDA, the C++ build on the
    CPU, as the JAX package builds them on its device), ops.coder's
    encode_core (kernel D4 on CUDA) and the d2h of the streams' bit counts.
    ``layout`` is the group's ``_FseLayout``. Returns the ``_FseEncoded``
    that ``_encode_drain_fse`` takes."""
    with _stage("ect.compress.fse_syms"):
        # the symbols laid out in one fresh array, which the h2d reads
        syms, init_syms = blocks_to_syms(blocks, layout.m, layout.R, k)
        syms = np.ascontiguousarray(syms)
        _count("host_bytes.compress.fse_syms",
               syms.nbytes + init_syms.nbytes)
    with _stage("ect.compress.fse_h2d"):
        syms = to_device(syms, dev, non_blocking=True)
        init_syms = to_device(init_syms, dev, non_blocking=True)
        valid, finish_slots = layout.on(dev)
    with _stage("ect.compress.fse_dispatch"):
        tabs = PL.tables_from_norm(norm_tables, l2, dev, half="encode")
        return _FseEncoded(*encode_core(
            syms, valid, init_syms, finish_slots,
            (tabs.next_state, tabs.tt_bits, tabs.tt_fs), k=k, L=l2,
            W=layout.W))


def _encode_drain_fse(dispatched, norm_tables, l2, shared_table, sections,
                      block_ids):
    """Collect one share that ``_encode_dispatch_fse`` queued and assemble
    its sections on the host: row j of ``norm_tables`` codes block
    ``block_ids[j]`` into ``sections[block_ids[j]]``, with its histogram
    header unless ``shared_table``."""
    with _stage("ect.compress.fse_collect"):
        words = dispatched.words()
        total_bits = dispatched.total_bits
    with _stage("ect.compress.fse_assemble"):
        for j, bid in enumerate(block_ids):
            nbytes = (int(total_bits[j]) + 7) // 8
            payload = words[j].view(np.uint8)[:nbytes]  # the wire's LE words
            sections[bid] = (payload.tobytes() if shared_table else
                             b"".join((_write_header(norm_tables[j], l2),
                                       payload)))
            _count("host_bytes.compress.sections", len(sections[bid]))


def _encode_tail(tail, k, table_log, shared_table, s_shared, sections,
                 modes, idx, dev, lanes=False, bit_pack=False):
    """Encode the ragged last block: the per-lane path when the tail happens
    to be lane-divisible (same eligibility as full blocks), the
    shared-stream path otherwise. ``s_shared`` is the frame's shared
    (table, log2) pair, if any."""
    n = len(tail)
    k_t = min(k, n)  # every stream needs at least one byte
    if n < 8:
        modes[idx] = MODE_RAW
        sections[idx] = tail.tobytes()
        _count("host_bytes.compress.escapes", n)
        return
    try:
        if shared_table:
            norm_tables = np.asarray(s_shared[0])[None]
            log2_arr = np.array([s_shared[1]])
        else:
            counts = np.bincount(tail, minlength=256).astype(np.uint32)[None]
            norm_tables, log2_arr = normalize_batch(counts, n, table_log)
        tmp_sections = [b""]
        tmp_modes = np.full(1, MODE_FSE, np.int32)
        _encode_group(tail[None, :], norm_tables, log2_arr, k_t,
                      shared_table, tmp_sections, tmp_modes, np.array([0]),
                      (dev,), lanes=lanes, bit_pack=bit_pack)()
        sections[idx] = tmp_sections[0]
        modes[idx] = tmp_modes[0]
    except ValueError:
        modes[idx] = MODE_RAW
        sections[idx] = tail.tobytes()
        _count("host_bytes.compress.escapes", n)


# --- decompress ---------------------------------------------------------------


@dataclass
class _ParsedFrame:
    k: int
    block_size: int
    total_len: int
    n_blocks: int
    shared: bool
    shared_hdr: bytes
    modes: np.ndarray
    lens: np.ndarray
    offs: np.ndarray  # absolute offset of each block section in the frame
    frame: bytes
    crcs: np.ndarray | None = None
    packed: bool = False

    def section(self, i: int) -> bytes:
        """Block i's section bytes (lazy: a range decode touches only the
        sections it needs)."""
        o = int(self.offs[i])
        return self.frame[o: o + int(self.lens[i])]


def _parse_frame(frame: bytes) -> _ParsedFrame:
    hdr_len = 4 + struct.calcsize("<BBHIQI")
    if len(frame) < hdr_len:
        raise ValueError("truncated frame: header")
    if frame[:4] != MAGIC:
        raise ValueError("bad magic")
    version, flags, k, block_size, total_len, n_blocks = struct.unpack_from(
        "<BBHIQI", frame, 4)
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    if flags & ~(FLAG_SHARED | FLAG_CRC | FLAG_PACKED):
        raise ValueError(f"unknown frame flags 0x{flags:02x}")
    if k < 1 or block_size < 1:
        raise ValueError("corrupt frame: zero k or block_size")
    if n_blocks != (total_len + block_size - 1) // block_size:
        raise ValueError("corrupt frame: block count mismatch")
    off = hdr_len
    shared = bool(flags & FLAG_SHARED)
    shared_hdr = b""
    if shared:
        if len(frame) < off + 2:
            raise ValueError("truncated frame: shared header length")
        (hlen,) = struct.unpack_from("<H", frame, off)
        off += 2
        if len(frame) < off + hlen:
            raise ValueError("truncated frame: shared header")
        shared_hdr = frame[off: off + hlen]
        off += hlen
    if len(frame) < off + 4 * n_blocks:
        raise ValueError("truncated frame: block table")
    entries = np.frombuffer(frame, np.uint32, count=n_blocks, offset=off)
    off += 4 * n_blocks
    modes = (entries >> 30).astype(np.int32)
    lens = (entries & ((1 << 30) - 1)).astype(np.int64)
    crcs = None
    if flags & FLAG_CRC:
        if len(frame) < off + 4 * n_blocks:
            raise ValueError("truncated frame: crc table")
        crcs = np.frombuffer(frame, np.uint32, count=n_blocks,
                             offset=off).copy()
        off += 4 * n_blocks
    offs = (off + np.concatenate([[0], np.cumsum(lens)[:-1]]) if n_blocks
            else np.zeros(0, np.int64))
    if n_blocks and len(frame) < off + int(lens.sum()):
        raise ValueError("truncated frame: sections")
    return _ParsedFrame(k, block_size, total_len, n_blocks, shared,
                        shared_hdr, modes, lens, offs, frame, crcs,
                        bool(flags & FLAG_PACKED))


# CPython's own constructor of a ``bytes`` object whose contents the caller
# writes before anyone else sees it (``str`` NULL), and its storage's address
_PyBytes_FromStringAndSize = ctypes.PYFUNCTYPE(
    ctypes.py_object, ctypes.c_char_p, ctypes.c_ssize_t)(
        ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_PyBytes_AsString = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))


def _new_bytes(n: int) -> tuple[bytes, np.ndarray]:
    """A new ``bytes`` of ``n`` uninitialised bytes and a writable uint8
    view of its storage, to be written in full before the object is handed
    out. The view holds the object (its ``base``), so it never outlives the
    storage, whatever keeps it. ``n == 0`` gives ``b""``, the shared empty
    object, and an empty array that is no view of it."""
    if n == 0:
        return b"", np.empty(0, np.uint8)
    obj = _PyBytes_FromStringAndSize(None, n)
    view = np.asarray(types.SimpleNamespace(obj=obj, __array_interface__=dict(
        data=(_PyBytes_AsString(obj), False), shape=(n,), typestr="|u1",
        version=3)))
    return obj, view


def _subframe_parts(pf: _ParsedFrame):
    """(entries u32, crcs | None, payload bytes) of a parsed frame: the
    pieces a larger frame assembles from sub-frames (the ordered multi-host
    merge, ``parallel.multihost``)."""
    entries = ((pf.modes.astype(np.uint32) << 30)
               | pf.lens.astype(np.uint32))
    payload = (pf.frame[int(pf.offs[0]): int(pf.offs[-1] + pf.lens[-1])]
               if pf.n_blocks else b"")
    return entries, pf.crcs, payload


@_call_range("decompress")
def decompress(frame: bytes, *, start: int = 0, length: int | None = None,
               out=None, device=None, sharding=None):
    """Decompress a container frame back to bytes (frames of either
    package).

    ``start``/``length`` decode only the blocks overlapping that byte range
    and return exactly that slice. When the frame carries per-block crc32s,
    each decoded block is verified. ``out``: optional writable buffer the
    decoded range is written into (returns the byte count written instead
    of ``bytes``). A block-aligned range given ``out`` decodes straight into
    it; every other call decodes its blocks into one fresh ``bytes``, which
    a whole frame or a block-aligned range returns as it is, and of which an
    unaligned range returns (or copies into ``out``) the slice. On a
    ValueError (corrupt frame / crc mismatch) ``out``'s contents are
    unspecified, and the fresh ``bytes`` is zeroed before the error leaves
    the call. ``device`` is where the block work runs (default ``"cuda"``,
    which raises when CUDA is unavailable); ``sharding`` spreads it over
    ``sharding.mesh`` as in ``compress``."""
    with _stage("ect.decompress.parse"):
        pf = _parse_frame(frame)
    return _decompress_parsed(pf, start=start, length=length, out=out,
                              device=device, sharding=sharding)


def _decompress_parsed(pf: _ParsedFrame, *, start: int = 0,
                       length: int | None = None, out=None, device=None,
                       sharding=None):
    """Range-decode an already-parsed frame."""
    _count("calls.decompress")
    mesh = M.of_call(device, sharding)
    if length is None:
        length = pf.total_len - start
    if not (0 <= start <= pf.total_len and 0 <= length <= pf.total_len - start):
        raise ValueError("range outside frame")
    # the blocks the range overlaps (``_parse_frame`` refuses a zero block
    # size); the output buffer spans only them, and they write it whole
    b_lo = start // pf.block_size
    b_hi = _cdiv(start + length, pf.block_size) if length else b_lo
    wanted = range(b_lo, min(b_hi, pf.n_blocks))
    base = b_lo * pf.block_size
    span = min(wanted.stop * pf.block_size, pf.total_len) - base
    aligned = start == base and span == length
    view = None if out is None else memoryview(out).cast("B")
    if view is not None:
        if view.readonly:
            raise ValueError("out buffer is read-only")
        if view.nbytes < length:
            raise ValueError(
                f"out buffer too small: {view.nbytes} < {length}")
    if view is not None and aligned:
        # block-aligned range: decode straight into the caller's buffer
        fresh, out = None, np.frombuffer(view, np.uint8, count=span)
    else:
        # one fresh bytes: returned as it is over a block-aligned range,
        # else the staging of the range's slice
        fresh, out = _new_bytes(span)
        if view is None and aligned:
            _count("host_bytes.decompress.output", span)
            _count("decompress.in_place")
        else:
            _count("host_bytes.decompress.out_buffer", span)

    try:
        shared_tbl = shared_l2 = None
        if pf.shared:
            shared_tbl, shared_l2, rest = _read_block_header(pf.shared_hdr)
            if rest:
                raise ValueError(
                    "trailing bytes after shared histogram header")

        with _stage("ect.decompress.parse"):
            # group FSE blocks by (raw_len, log2) for batched decode
            groups: dict[tuple[int, int], list] = {}
            pl_groups: dict[tuple[int, int], list] = {}
            for i in wanted:
                mode, sec = int(pf.modes[i]), pf.section(i)
                _count("host_bytes.decompress.sections", _copied(sec))
                rl = min(pf.block_size, pf.total_len - i * pf.block_size)
                o = i * pf.block_size - base
                if mode == MODE_RAW:
                    if len(sec) != rl:
                        raise ValueError(f"raw block {i} length mismatch")
                    out[o: o + rl] = np.frombuffer(sec, np.uint8)
                elif mode == MODE_RLE:
                    if len(sec) != 1:
                        raise ValueError(f"rle block {i} length mismatch")
                    out[o: o + rl] = sec[0]
                elif mode in (MODE_FSE, MODE_FSE_PL):
                    if pf.shared:
                        tbl, l2, payload = shared_tbl, shared_l2, sec
                    else:
                        tbl, l2, payload = _read_block_header(sec)
                        _count("host_bytes.decompress.payloads",
                               _copied(payload))
                    dst = pl_groups if mode == MODE_FSE_PL else groups
                    dst.setdefault((rl, l2), []).append(
                        (i, payload, tbl,
                         int(pf.offs[i]) + len(sec) - len(payload)))
                else:
                    raise ValueError(f"bad block mode {mode}")

        # each group splits into one contiguous share per mesh entry; every
        # share of every group, MODE_FSE and per-lane, is dispatched on its
        # own device before the first is drained (the JAX package's one
        # call over the mesh)
        fse_calls, pl_calls = ([(items, rl, l2, M.shares(len(items), mesh))
                                for (rl, l2), items in g.items()]
                               for g in (groups, pl_groups))
        fse_queued = [M.dispatch("decompress", shares, lambda s:
                                 _decode_dispatch_fse(items[s.lo: s.hi], rl,
                                                      l2, pf, s.device))
                      for items, rl, l2, shares in fse_calls]
        # device repack: the span of the frame that holds a device's per-lane
        # payloads goes to it once, whatever the number of groups and shares
        spans: dict = {}
        for items, _, _, shares in pl_calls:
            for s in shares:
                if _device_repack(s.device):
                    first, last = items[s.lo], items[s.hi - 1]
                    lo, hi = spans.get(s.device, (first[3], 0))
                    spans[s.device] = (min(lo, first[3]),
                                       max(hi, last[3] + len(last[1])))
        with _stage("ect.decompress.h2d"):
            pinned = M.spans_cards(mesh)
            on_dev = {dev: (DR.bytes_on(pf.frame, lo, hi, dev,
                                        non_blocking=pinned), lo)
                      for dev, (lo, hi) in spans.items()}
        pl_queued = [M.dispatch("decompress", shares, lambda s:
                                _decode_dispatch_pl(items[s.lo: s.hi], rl, l2,
                                                    pf, s.device,
                                                    on_dev.get(s.device)))
                     for items, rl, l2, shares in pl_calls]
        for (items, rl, _, shares), queued in zip(fse_calls, fse_queued):
            M.drain("decompress", shares, queued, lambda s, q: (
                _decode_drain_fse(q, items[s.lo: s.hi], rl, pf, out, base)))
        for (items, rl, _, shares), queued in zip(pl_calls, pl_queued):
            M.drain("decompress", shares, queued, lambda s, q: (
                _decode_drain_pl(q, items[s.lo: s.hi], rl, pf, out, base)))
        # block -> its crc as the device computed it
        crcs = {i: crc for queued in pl_queued for q in queued
                for i, crc in q.crcs.items()}
        with _stage("ect.decompress.output"):
            if pf.crcs is not None:
                with _stage("ect.decompress.crc"):
                    # the per-lane blocks' crcs came back with their bytes;
                    # the other blocks are checksummed on the host
                    on_card = 0
                    for i in wanted:
                        rl = min(pf.block_size,
                                 pf.total_len - i * pf.block_size)
                        crc = crcs.get(i)
                        if crc is None:
                            o = i * pf.block_size - base
                            crc = zlib.crc32(out[o: o + rl])
                        else:
                            on_card += rl
                        if crc != int(pf.crcs[i]):
                            raise ValueError(
                                f"block {i}: crc mismatch (corrupt frame)")
                _count("crc.decompress", span)
                if on_card:
                    _count("crc.decompress.device", on_card)
            a = start - base
            if view is not None:
                if fresh is not None:  # unaligned range: one staging copy
                    np.frombuffer(view, np.uint8, count=length)[:] = \
                        out[a: a + length]
                result = length
            elif aligned:
                result = fresh
            else:  # unaligned range: the slice, a copy
                result = fresh[a: a + length]
                _count("host_bytes.decompress.output", length)
    except BaseException:
        if fresh is not None:
            # a failed call hands out nothing: the traceback's frames still
            # reach the fresh object, so none of its stale or partly
            # written bytes stays readable there
            out.fill(0)
        raise
    with _stage("ect.decompress.release"):
        # the call's host buffers, and the loops' last references to them,
        # go inside its range, not after it
        del out, fresh, view, groups, pl_groups, fse_calls, pl_calls
        del fse_queued, pl_queued, on_dev, crcs
        sec = payload = items = first = last = queued = None
    return result


def _copied(buf) -> int:
    """The bytes of ``buf`` when slicing the frame copied them (a ``bytes``
    or ``bytearray`` frame), 0 for a view (a ``memoryview`` frame)."""
    return 0 if isinstance(buf, memoryview) else len(buf)


def _decode_dispatch_pl(items, raw_len, log2, pf, dev, span=None):
    """Queue the decode of MODE_FSE_PL blocks sharing one (raw_len, log2)
    on ``dev``: the lane sizes and framing are checked on the host (a
    corrupt block raises ValueError here, before anything of this call is
    queued), the lane split fills the (B, W, k) word layout, and B1 (its
    plain version on CPU) decodes ~64 MiB of raw bytes per call; on a frame
    with crcs each call's blocks are checksummed behind it, where they were
    decoded (``ops.crc``), and their crcs come back with them. ``items``
    are (block, payload, table, the payload's offset in the frame). With
    ``span`` (a uint8 tensor on ``dev`` holding the frame from byte
    ``span[1]`` on, past every item's payload) the split runs on the device
    (D2) from those bytes; without it the C++ split runs on the host and
    the words are copied. The group's decode tables are built once, before
    the first chunk, and held until the last is collected. Returns the
    ``_Queued`` that ``_decode_drain_pl`` takes, its ``crcs`` for its drain
    to fill."""
    k = pf.k
    if not (TABLE_LOG_MIN <= log2 <= TABLE_LOG_MAX):
        raise ValueError(f"corrupt frame: table log {log2} out of range")
    if k % 128 != 0 or raw_len % k != 0 or raw_len // k < 2:
        raise ValueError("corrupt frame: FSE_PL block not lane-divisible")
    R = raw_len // k - 1
    B = len(items)
    sizes = np.zeros((B, k), np.int32)
    payloads = []  # each block's lane streams, for the C++ split only
    lane_offs = np.zeros(B, np.int64)  # each block's lane streams, in frame
    norm_tables = np.zeros((B, 256), np.int32)
    with _stage("ect.decompress.checks"):
        for j, (i, sec, nt, sec_off) in enumerate(items):
            if pf.packed:
                # bit-packed wire (FLAG_PACKED): compressed size table, then
                # bit-granularity lane streams (total bits, last dead bits 0)
                sz, lanes_sec = _unpack_size_table(sec, k)
                if (sz < log2).any() or (sz > (R + 1) * log2).any():
                    # the encoder never emits more than (R+1)*log2 bits per
                    # lane; an oversized claim would make the words allocation
                    # scale with the claim, not the payload
                    raise ValueError(f"block {i}: bad lane sizes")
                total = int(sz.astype(np.int64).sum())
                if (total + 7) // 8 != len(lanes_sec):
                    raise ValueError(f"block {i}: bad lane sizes")
                if total & 7 and lanes_sec[-1] >> (total & 7):
                    raise ValueError(f"block {i}: lane framing error")
                _count("host_bytes.decompress.payloads", _copied(lanes_sec))
                sizes[j] = sz
                if span is None:
                    payloads.append(lanes_sec)
                lane_offs[j] = sec_off + len(sec) - len(lanes_sec)
                norm_tables[j] = nt
                continue
            if len(sec) < 2 * k:
                raise ValueError(f"block {i}: truncated lane sizes")
            sz = np.frombuffer(sec[: 2 * k], "<u2").astype(np.int32)
            if (sz < log2).any() or (sz > (R + 1) * log2).any():
                raise ValueError(f"block {i}: bad lane sizes")
            if int(((sz + 7) >> 3).sum()) != len(sec) - 2 * k:
                raise ValueError(f"block {i}: bad lane sizes")
            # framing check (the marker-bit rule's per-lane analog, reference
            # src/bitstream/stack_reader.rs:81-83): the dead bits above each
            # lane's top bit must be zero
            buf = np.frombuffer(sec, np.uint8, offset=2 * k)
            last = buf[np.cumsum((sz + 7) >> 3) - 1].astype(np.int32)
            if (last >> (((sz - 1) & 7) + 1)).any():
                raise ValueError(f"block {i}: lane framing error")
            sizes[j] = sz
            if span is None:
                payloads.append(sec[2 * k:])
                _count("host_bytes.decompress.payloads",
                       _copied(payloads[-1]))
            lane_offs[j] = sec_off + 2 * k
            norm_tables[j] = nt
    W = -(-(int(sizes.max()) // 32 + 3) // 16) * 16

    # the host queues every chunk's split (or, on the host route, splits
    # and queues the h2d) and dispatches its kernel; the drain comes later,
    # in order, so the write-back of chunk i overlaps the device decode of
    # the chunks after it (entropy_coders_tpu/frame.py:854-868)
    chunk = max(1, _cdiv(_CHUNK_RAW, raw_len))
    chunks = []
    with _stage("ect.decompress.dispatch"):
        # the group's decode tables, built once (D3 on CUDA), 2^L * 4 bytes
        # a block until the last chunk is collected; each call reads its rows
        tables = PL.tables_from_norm(norm_tables, log2, dev, half="decode")
        for j0 in range(0, B, chunk):
            sizes_dev = to_device(sizes[j0: j0 + chunk], dev, non_blocking=True)
            if span is not None:
                # every check above has passed: each block's streams lie
                # inside its section, so inside the bytes on the device
                words = DR.lane_split_device(
                    span[0], to_device(lane_offs[j0: j0 + chunk] - span[1], dev,
                                       non_blocking=True),
                    sizes_dev, k=k, W=W, pack_bits=bool(pf.packed))
            else:
                with _stage("ect.decompress.split_cpp"):
                    words = PL.lane_split_batch(
                        payloads[j0: j0 + chunk], sizes[j0: j0 + chunk], k,
                        W, pack_bits=bool(pf.packed))
                    _count("host_bytes.decompress.split", words.nbytes)
                words = to_device(words, dev, non_blocking=True)
            chunks.append((j0, PL.decode_lanes_norm(
                words, sizes_dev, norm_tables[j0: j0 + chunk], k=k, L=log2, R=R,
                lazy=True, tables=PL.table_rows(tables, j0, j0 + chunk),
                crc=pf.crcs is not None)))
    return _Queued(chunks, tables, crcs={})


def _decode_drain_pl(dispatched, items, raw_len, pf, out, out_base):
    """Collect the chunks ``_decode_dispatch_pl`` queued, in order (a lane
    cursor not drained raises ValueError), and write their blocks back
    into ``out``; on a frame with crcs, each block's crc as the device
    computed it goes into the handle's ``crcs``."""
    for j0, collect in dispatched.chunks:
        with _stage("ect.decompress.collect"):
            syms, finals, *got = collect()
            for jj, crc in enumerate(got[0] if got else ()):
                dispatched.crcs[items[j0 + jj][0]] = int(crc)
        with _stage("ect.decompress.write_back"):
            n_syms = syms.shape[1] * syms.shape[2]
            for jj in range(syms.shape[0]):
                o = items[j0 + jj][0] * pf.block_size - out_base
                out[o: o + n_syms] = syms[jj].reshape(-1)
                out[o + n_syms: o + raw_len] = finals[jj]


def _decode_dispatch_fse(items, raw_len, log2, pf, dev):
    """Queue the decode of shared-stream (MODE_FSE) blocks sharing one
    (raw_len, log2) on ``dev``, waiting for nothing on the card. Every host
    check of the share runs first: a payload with no marker bit, or one
    whose marker lies more than 8 bits from its end, raises ValueError
    before anything of the share is queued. Then the payload words
    (zero-padded to the share's longest, and two guard words) and the
    marker positions go to the card from pinned staging, the decode tables
    are built as ``_encode_dispatch_fse`` builds them, ops.coder's
    decode_core runs (kernel D5 on CUDA) and the d2h of its outputs is
    queued. ``items`` are (block, payload, table, the payload's offset in
    the frame). Returns the d2h's handle (``unsigned.Later``), which
    ``_decode_drain_fse`` takes."""
    k = min(pf.k, raw_len)
    B = len(items)
    with _stage("ect.decompress.fse_checks"):
        max_bytes = max(len(p) for _, p, _, _ in items)
        Wd = _cdiv(max_bytes, 4) + 2
        words = np.zeros((B, Wd), np.uint32)
        _count("host_bytes.decompress.fse_words", words.nbytes)
        word_bytes = words.view(np.uint8)  # little-endian words, as the wire
        total_bits = np.zeros(B, np.int64)
        norm_tables = np.zeros((B, 256), np.int32)
        for j, (i, payload, nt, _) in enumerate(items):
            buf = np.frombuffer(payload, np.uint8)
            # the marker is the top set bit; it lies within 8 bits of the
            # end only if it is in the last byte
            if not len(buf) or buf[-1] == 0:
                raise ValueError(f"block {i}: " + (
                    "framing error" if buf.any() else "missing marker bit"))
            total_bits[j] = (len(buf) - 1) * 8 + int(buf[-1]).bit_length() - 1
            word_bytes[j, : len(buf)] = buf
            norm_tables[j] = nt
    with _stage("ect.decompress.fse_h2d"):
        words = to_device(words, dev, non_blocking=True)
        total_bits = to_device(total_bits, dev, non_blocking=True)
    m = raw_len - k
    R = max(_cdiv(m, k), 1) + 1
    with _stage("ect.decompress.fse_dispatch"):
        packed = PL.tables_from_norm(norm_tables, log2, dev,
                                     half="decode").dec
        syms, emit_count, finals, done, _c = decode_core(
            words, total_bits, packed, k=k, L=log2, R=R)
        return d2h([syms, emit_count, finals, done])


def _decode_drain_fse(dispatched, items, raw_len, pf, out, out_base):
    """Collect one share that ``_decode_dispatch_fse`` queued (a block
    whose decode did not finish, or finished at another length, raises
    ValueError) and write its blocks back into ``out``."""
    m = raw_len - min(pf.k, raw_len)
    with _stage("ect.decompress.fse_collect"):
        syms, emit_count, finals, done = dispatched.get()
    if not done.all():
        raise ValueError("decode did not terminate: corrupt frame")
    if not (emit_count == m).all():
        raise ValueError("decoded length mismatch: corrupt frame")
    with _stage("ect.decompress.fse_write_back"):
        syms = syms.reshape(len(items), -1)
        for j, (i, _, _, _) in enumerate(items):
            o = i * pf.block_size - out_base
            out[o: o + m] = syms[j, :m]
            out[o + m: o + raw_len] = finals[j]

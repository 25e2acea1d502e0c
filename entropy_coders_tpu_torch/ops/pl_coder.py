"""Per-lane-stream tANS encode/decode (MODE_FSE_PL), PyTorch + CUDA.

Counterpart of ``entropy_coders_tpu/ops/pl_coder.py``. Each of k lanes owns
its own bit stream: lane i of a block codes the bytes {i, i+k, i+2k, ...} as
exactly a reference-format single-stream FSE payload (reversed LSB-first bit
stack, the initial state folding the lane's last byte, the final state in
table_log bits). Bit j of a lane's stream lives in word j >> 5 at position
j & 31 of the lane's word column, as in the JAX package.

Two kernels carry the path, each behind a wrapper that checks its inputs
(named after the JAX package's ``_decode_call`` / ``_encode_call``, which
launch the Pallas kernels):

* ``decode_call`` -> B1, ``csrc/pl_decode.cu`` (replaces ``_decode_kernel``);
* ``encode_call`` -> B2, ``csrc/pl_encode.cu`` (replaces ``_encode_kernel``).

A wrapper launches its kernel for CUDA tensors and raises if it cannot. For
CPU tensors it runs the plain PyTorch version (``decode_call_ref`` /
``encode_call_ref``): vectorised over (B, k), a Python loop over rounds,
int64 throughout. The plain versions are the oracle the kernels are held
against on the card. ``DECODE_LAUNCHES``/``ENCODE_LAUNCHES`` count kernel
launches, so a run can show that its path went through the kernels;
``DECODE_BLOCKS`` counts the blocks B1 decoded, so a range decode can show
that it touched only its blocks.

``decode_lanes``/``encode_lanes``/``encode_w_bound`` are the JAX package's
public lane entries with its signatures (less its TPU knobs ``interpret``,
``mesh``, ``e_rounds`` and ``small_alpha``, which change no byte): prebuilt
tables in the ``spec.fse`` layout, numpy arrays or tensors in, one B1 or B2
launch each.

``encode_lanes_norm``/``decode_lanes_norm`` take ``lazy=True``: the kernel
is launched and its d2h queued on a side stream, and a ``collect`` closure
waits on that chunk's event alone (the container dispatches every chunk,
then drains them in order).

Tables are flat (``tables_from_norm``), bit-identical to the reference's:
built on the host by the port's C++ library (``native``) or, on the
``host_tables=False`` route, on the device by ``ops.tables`` (kernel D3).
None of the TPU's gather-row layouts, epochs or fusion carry over: they
change no wire byte.

The host-side lane repack (wire <-> padded (W, k) words) is the C++
library's: ``lane_merge_batch``/``lane_split_batch`` for a block group, and
the JAX package's single-block entries ``lane_split``, ``lane_merge``,
``lane_merge_bits`` and ``lane_split_bits`` over them. The repack on the
card is ``ops.device_repack``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import native
from ..kernels.launch import check as _check, launch as _launch
from . import tables as TB
from .crc import crc32_blocks
from .unsigned import (as_int64, d2h, entry_device, entry_tensor,
                       int64_to_u32, launched, signed_view, to_device)

__all__ = [
    "DECODE_BLOCKS",
    "DECODE_LAUNCHES",
    "ENCODE_LAUNCHES",
    "LaneTables",
    "decode_call",
    "decode_call_ref",
    "decode_lanes",
    "decode_lanes_norm",
    "encode_call",
    "encode_call_ref",
    "encode_lanes",
    "encode_lanes_norm",
    "encode_w_bound",
    "lane_config",
    "lane_merge",
    "lane_merge_batch",
    "lane_merge_bits",
    "lane_split",
    "lane_split_batch",
    "lane_split_bits",
    "table_rows",
    "tables_from_norm",
]

DECODE_LAUNCHES = 0  # B1 launches since import (or since a caller reset it)
ENCODE_LAUNCHES = 0  # B2 launches
DECODE_BLOCKS = 0    # blocks decoded by those B1 launches


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


class LaneTables(NamedTuple):
    """Flat per-block tables on one device (B blocks sharing table log L)."""
    dec: torch.Tensor         # (B, 2^L) uint32: sym << 24 | nb << 16 | base
    tt_bits: torch.Tensor     # (B, 256) uint32 symbol-transform bits
    tt_fs: torch.Tensor       # (B, 256) int32 symbol-transform find_state
    next_state: torch.Tensor  # (B, 2^L) uint16 encode next-state table


# What ``host_tables=None`` means on a CUDA device: the route that was
# faster end to end at the default point (1,024 tables a 128 MiB call; see
# ``tables_from_norm``). Also the private switch ``chip_smoke.py`` flips
# to run the two routes in turns.
HOST_TABLES_ON_CUDA = False


def tables_from_norm(norm_tables: np.ndarray, L: int, device,
                     host_tables: bool | None = None,
                     half: str = "both") -> LaneTables:
    """(B, 256) int32 normalized histograms sharing table log ``L`` -> the
    flat tables on ``device``: the half a caller reads (``half="decode"``:
    ``dec``, what B1 reads; ``"encode"``: ``tt_bits``, ``tt_fs`` and
    ``next_state``, what B2 reads; the JAX package builds only the half it
    reads too, ``pl_coder.py:775-778, 931``) or ``"both"``. The fields of
    the half not built are None.

    ``host_tables`` picks the route, as in the JAX package
    (``pl_coder.py:736, 895``); both give identical bytes (tests pin it).
    ``True``: built on the host by ``native.build_decode_tables`` /
    ``build_encode_tables`` and copied. ``False``: the counts are checked
    on the host, copied, and ``ops.tables.build_tables`` builds the tables
    where they are used: kernel D3 on a CUDA device, its plain version on
    the CPU. ``None``: the C++ build on the CPU; on CUDA the device build
    (``HOST_TABLES_ON_CUDA``), the faster route end to end at the default
    point, 128 MiB in 1,024 blocks of 128 KiB, on an NVIDIA H100 80GB HBM3
    at 700.00 W (``chip_smoke.py`` phase ``routes``, medians of four runs
    in turns, in two calls: compress 169 and 184 ms against 211 and 250 ms
    with the tables built on the host, decompress 365 and 296 ms against
    396 and 297 ms; in two later calls of six runs the two were within
    4 ms of each other, and at 8 tables a call the routes tie). A CUDA
    copy is queued without waiting for the card (``unsigned.to_device``'s
    ``non_blocking``), so a lazy call dispatches behind the chunks before
    it. A malformed table raises ValueError on either route. The build is
    a stage of the direction that reads it, the ``torch.profiler`` range
    ``ect.decompress.tables`` for the decode half and
    ``ect.compress.tables`` otherwise."""
    want = TB.half_code(half)
    dev = torch.device(device)
    if host_tables is None:
        host_tables = HOST_TABLES_ON_CUDA if dev.type == "cuda" else True
    op = "decompress" if half == "decode" else "compress"
    with record_function(f"ect.{op}.tables"):
        if not host_tables:
            nt = TB.check_norm_tables(norm_tables, int(L))
            return LaneTables(*TB.build_tables(
                to_device(nt, dev, non_blocking=True), int(L), half))
        nt = np.ascontiguousarray(norm_tables, np.int32)
        dec = table = tt_bits = tt_fs = None
        if want & 2:
            table, tt_bits, tt_fs = native.build_encode_tables(nt, int(L))
        if want & 1:
            dec = native.build_decode_tables(nt, int(L))
        return LaneTables(*(None if t is None else
                            to_device(t, dev, non_blocking=True)
                            for t in (dec, tt_bits, tt_fs, table)))


def table_rows(tables: LaneTables, lo: int, hi: int) -> LaneTables:
    """Rows [lo, hi) of every built field of ``tables``: views, each
    contiguous (a field's rows are)."""
    return LaneTables(*(None if t is None else t[lo:hi] for t in tables))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data is not 16-byte aligned (the
    kernels move tables and tiles in 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_index_range(*, bound: int = 1 << 31, **extents) -> None:
    """The kernels index a block's arrays in 32 bits: raise when an extent
    reaches ``bound`` (2^31 for a signed index, 2^32 for an unsigned byte
    offset)."""
    for name, n in extents.items():
        if n >= bound:
            raise ValueError(f"{name}={n} is past the kernels' 32-bit "
                             "index range")


def lane_config(kind: str, k: int, L: int) -> tuple[int, int]:
    """(T, group) that B1 (``kind="decode"``) or B2 (``"encode"``) launch
    with for k lanes at table log L. T is the threads of a CTA, each a lane
    of one block: 512 from L = 13, where the 2^L-entry table leaves room
    for few CTAs an SM, so that one table copy serves more warps; else 256;
    the largest of these that divides k, down to 128. On an H100 at the
    main path's launch shapes (``tools/lane_shapes.py --sweep``), 512 took
    27-36% off both kernels at L=15 and 1-6% at L=13, and lost up to 40% at
    L=11 (32,768 lanes fill only half the SMs with 512-thread CTAs). The
    group is the rounds between B2's flushes, 4 while four rounds of at
    most L bits fit 32 (L <= 8) and else 2, or between B1's refill checks,
    2 while two rounds take at most 20 bits (L <= 10) and else 1."""
    T = 512 if L >= 13 else 256
    while k % T:
        T //= 2
    if kind == "encode":
        return T, 4 if L <= 8 else 2
    return T, 2 if L <= 10 else 1


# ---------------------------------------------------------------------------
# Decode: B1 and its plain version
# ---------------------------------------------------------------------------


def _read_bits(words: torch.Tensor, c: torch.Tensor, nb) -> torch.Tensor:
    """Bits [c, c + nb) of every lane's stream, nb <= 16. ``words`` is the
    (B, W, k) int64 word array; rows outside [0, W) read as zero (a corrupt
    stream's cursor can go negative)."""
    W = words.shape[1]
    row = c >> 5  # floor, also for negative cursors
    off = c & 31

    def word(r):
        ok = (r >= 0) & (r < W)
        g = torch.gather(words, 1, r.clamp(0, W - 1).unsqueeze(1)).squeeze(1)
        return torch.where(ok, g, 0)

    # only the next word's low 16 bits can reach an nb <= 16 read
    v = (word(row) >> off) | ((word(row + 1) & 0xFFFF) << (32 - off))
    return v & ((torch.ones_like(c) << nb) - 1)


def decode_call_ref(words, sizes, dec, *, L: int, R: int):
    """Plain PyTorch version of B1 (same inputs and outputs as
    ``decode_call``), vectorised over (B, k), a loop over R rounds."""
    B, W, k = words.shape
    w = as_int64(words)
    tab = as_int64(dec)
    mask_L = (1 << L) - 1
    c = sizes.to(torch.int64) - L
    state = _read_bits(w, c, L) & mask_L
    syms = torch.empty((B, R, k), dtype=torch.uint8, device=words.device)
    for r in range(R):
        e = torch.gather(tab, 1, state)
        nb = (e >> 16) & 0xFF
        c = c - nb
        state = ((e & 0xFFFF) + _read_bits(w, c, nb)) & mask_L
        syms[:, r] = (e >> 24).to(torch.uint8)
    finals = (torch.gather(tab, 1, state) >> 24).to(torch.uint8)
    return syms, finals, c.to(torch.int32)


def decode_call(words, sizes, dec, *, L: int, R: int):
    """Decode B blocks of k per-lane streams (B1's wrapper).

    words: (B, W, k) uint32 lane words (rows past the streams zero).
    sizes: (B, k) int32 per-lane stream lengths in bits.
    dec: (B, 2^L) uint32 decode entries (``LaneTables.dec``).
    Returns (syms (B, R, k) uint8, finals (B, k) uint8, cursors (B, k)
    int32): every cursor of a well-formed stream ends at 0.

    CUDA tensors launch B1 (and raise if the launch fails); CPU tensors run
    ``decode_call_ref``."""
    global DECODE_BLOCKS, DECODE_LAUNCHES
    if words.dim() != 3:
        raise ValueError(f"words must be (B, W, k), got {tuple(words.shape)}")
    B, W, k = words.shape
    dev = words.device
    if k % 128:
        raise ValueError(f"k={k} must be a multiple of 128")
    if not 5 <= L <= 15 or R < 0:
        raise ValueError(f"bad table log {L} or round count {R}")
    _check(words, "words", (B, W, k), torch.uint32, dev)
    _check(sizes, "sizes", (B, k), torch.int32, dev)
    _check(dec, "dec", (B, 1 << L), torch.uint32, dev)
    if dev.type == "cpu":
        return decode_call_ref(words, sizes, dec, L=L, R=R)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_index_range(W_k=W * k, R_k=R * k)
    words, sizes, dec = map(_aligned, (words, sizes, dec))
    syms = torch.empty((B, R, k), dtype=torch.uint8, device=dev)
    finals = torch.empty((B, k), dtype=torch.uint8, device=dev)
    cursors = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return syms, finals, cursors
    from ..kernels.build import load

    lib = load()
    with torch.cuda.device(dev):
        _launch(lib.ect_pl_decode, words.data_ptr(), sizes.data_ptr(),
                dec.data_ptr(), syms.data_ptr(), finals.data_ptr(),
                cursors.data_ptr(), B, W, k, L, R,
                *lane_config("decode", k, L),
                torch.cuda.current_stream(dev).cuda_stream)
    DECODE_LAUNCHES += 1
    DECODE_BLOCKS += B
    return syms, finals, cursors


def decode_lanes_norm(words, sizes, norm_tables, *, k: int, L: int, R: int,
                      lazy: bool = False, host_tables: bool | None = None,
                      tables: LaneTables | None = None, crc: bool = False):
    """Batched decode from lane words and the (B, 256) int32 normalized
    histograms (all sharing table log ``L``), the decode half of the tables
    built by ``tables_from_norm`` on the words' device (``host_tables``
    picks its route; the bytes out are identical), or ``tables`` when given
    (their ``dec``, already built: ``norm_tables`` is then not read; the
    container builds a lane group's tables once and hands each chunk its
    rows, ``table_rows``). words (B, W, k) uint32 and
    sizes (B, k) int32 tensors in; (syms (B, R, k) uint8, finals (B, k)
    uint8) out, on the same device. Raises ValueError on a corrupt stream
    (any lane cursor not exactly drained).

    ``lazy=True`` launches B1, queues the d2h of its outputs and returns a
    zero-argument ``collect`` (the JAX package's, ``pl_coder.py:953-965``):
    it waits for this call's copies only, raises the ValueError above, and
    returns host numpy (syms, finals). On the CPU the plain version has
    already run and ``collect`` returns its results. Callers dispatch
    every chunk and then collect them in order (``frame._decode_dispatch_pl``),
    so every chunk's words and outputs are on the card at once.

    ``crc=True`` also checksums each decoded block where it lies, its
    symbols then its finals (``ops.crc.crc32_blocks``, behind B1), and
    appends the (B,) uint32 crc32s to what is returned; lazily, their d2h
    goes with the outputs'."""
    if words.dim() != 3 or words.shape[2] != k:
        raise ValueError("k must match words (B, W, k)")
    if tables is None:
        tables = tables_from_norm(norm_tables, L, words.device, host_tables,
                                  half="decode")
    syms, finals, cursors = decode_call(words, sizes, tables.dec, L=L, R=R)
    outs = [syms, finals]
    if crc:
        outs.append(crc32_blocks(syms.reshape(syms.shape[0], -1), finals))
    if not lazy:
        if bool((cursors != 0).any()):
            raise ValueError("corrupt stream: lane cursor not drained")
        return tuple(outs)
    later = d2h([*outs, cursors])

    def collect():
        *got, cursors_h = later.get()
        if cursors_h.any():
            raise ValueError("corrupt stream: lane cursor not drained")
        return tuple(got)

    return collect


# ---------------------------------------------------------------------------
# Encode: B2 and its plain version
# ---------------------------------------------------------------------------


def encode_w_bound(R: int, L: int) -> int:
    """Worst-case word rows per lane: R rounds of <= L bits each plus the
    final L-bit state (new_first_symbol emits no bits), plus 2 guard rows,
    rounded up to 8 rows (the JAX package's layout; the value is kept so
    that both packages allocate the same words)."""
    return _cdiv(_cdiv(R * L + L, 32) + 2, 8) * 8


def encode_call_ref(blocks, tables: LaneTables, *, k: int, L: int, W: int):
    """Plain PyTorch version of B2 (same inputs and outputs as
    ``encode_call``), vectorised over (B, k), a loop over R rounds. Bits
    go into the int64 word array by add: every bit position is written
    once, so add is exact."""
    B, n = blocks.shape
    R = n // k - 1
    dev = blocks.device
    x = blocks.reshape(B, R + 1, k).to(torch.int64)
    tb_t = as_int64(tables.tt_bits)
    fs_t = tables.tt_fs.to(torch.int64)
    nxt = as_int64(tables.next_state)
    mask_L = (1 << L) - 1

    def put(words, c, val):
        # val < 2^16 at bit c: low part into row c >> 5, the rest into the
        # next row; rows past W are dropped, as the kernel drops them
        row = c >> 5
        off = c & 31
        for r, v in ((row, (val << off) & 0xFFFFFFFF), (row + 1, val >> (32 - off))):
            ok = r < W
            words.scatter_add_(1, r.clamp(max=W - 1).unsqueeze(1),
                               torch.where(ok, v, 0).unsqueeze(1))

    sym = x[:, R]
    tb = torch.gather(tb_t, 1, sym)
    bits_out = (tb >> 16) + 1
    value0 = (bits_out << 16) - tb
    state = torch.gather(nxt, 1, ((value0 >> bits_out)
                                  + torch.gather(fs_t, 1, sym)) & mask_L)
    words = torch.zeros((B, W, k), dtype=torch.int64, device=dev)
    c = torch.zeros((B, k), dtype=torch.int64, device=dev)
    for r in range(R - 1, -1, -1):
        sym = x[:, r]
        tb = torch.gather(tb_t, 1, sym)
        bits_out = (tb + state) >> 16
        put(words, c, state & ((torch.ones_like(bits_out) << bits_out) - 1))
        c = c + bits_out
        state = torch.gather(nxt, 1, ((state >> bits_out)
                                      + torch.gather(fs_t, 1, sym)) & mask_L)
    put(words, c, state & mask_L)
    return int64_to_u32(words), (c + L).to(torch.int32)


def encode_call(blocks, tables: LaneTables, *, k: int, L: int, W: int):
    """Encode B blocks of k per-lane streams (B2's wrapper).

    blocks: (B, (R+1)*k) uint8 raw block bytes; row r of lane i is byte
      r*k + i, and row R (each lane's last byte) folds into the initial
      state.
    tables: ``LaneTables`` for the B blocks at table log ``L``.
    W: word rows to allocate (``encode_w_bound(R, L)``).
    Returns (words (B, W, k) uint32, sizes (B, k) int32 bit counts).

    CUDA tensors launch B2 (and raise if the launch fails); CPU tensors run
    ``encode_call_ref``."""
    global ENCODE_LAUNCHES
    if blocks.dim() != 2:
        raise ValueError(f"blocks must be (B, n), got {tuple(blocks.shape)}")
    B, n = blocks.shape
    dev = blocks.device
    if k % 128 or n % k or n // k < 2:
        raise ValueError(f"k={k} must be a multiple of 128 dividing n={n} "
                         "into >= 2 rows")
    if not 5 <= L <= 15:
        raise ValueError(f"bad table log {L}")
    R = n // k - 1
    if W < _cdiv((R + 1) * L, 32):
        raise ValueError(f"W={W} rows cannot hold R={R} rounds at L={L}")
    _check(blocks, "blocks", (B, n), torch.uint8, dev)
    _check(tables.tt_bits, "tt_bits", (B, 256), torch.uint32, dev)
    _check(tables.tt_fs, "tt_fs", (B, 256), torch.int32, dev)
    _check(tables.next_state, "next_state", (B, 1 << L), torch.uint16, dev)
    if dev.type == "cpu":
        return encode_call_ref(blocks, tables, k=k, L=L, W=W)
    # B2 keeps a lane's next word as an unsigned 32-bit byte offset
    _check_index_range(n_plus_k=n + k)
    _check_index_range(word_bytes=4 * W * k, bound=1 << 32)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    blocks = _aligned(blocks)
    tables = LaneTables(*(None if t is None else _aligned(t)
                          for t in tables))
    # B2 writes every row, the zeros past each stream included
    words = torch.empty((B, W, k), dtype=torch.int32, device=dev).view(
        torch.uint32)
    sizes = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return words, sizes
    from ..kernels.build import load

    lib = load()
    with torch.cuda.device(dev):
        _launch(lib.ect_pl_encode, blocks.data_ptr(),
                tables.tt_bits.data_ptr(), tables.tt_fs.data_ptr(),
                tables.next_state.data_ptr(), words.data_ptr(),
                sizes.data_ptr(), B, k, L, R, W,
                *lane_config("encode", k, L),
                torch.cuda.current_stream(dev).cuda_stream)
    ENCODE_LAUNCHES += 1
    return words, sizes


def _w_act(max_bits: int, W: int) -> int:
    """The JAX package's count of populated word rows."""
    return min(_cdiv(max_bits // 32 + 2, 16) * 16, W)


def encode_lanes_norm(blocks, norm_tables, *, k: int, L: int, W: int,
                      lazy: bool = False, host_tables: bool | None = None,
                      tables: LaneTables | None = None):
    """Batched encode from raw blocks (B, n) uint8 with n = (R+1)*k and the
    (B, 256) int32 normalized histograms (all sharing table log ``L``), the
    encode half of the tables built by ``tables_from_norm`` on the blocks'
    device (``host_tables`` picks its route; the bytes out are identical),
    or ``tables`` when given (already built: ``norm_tables`` is then not
    read).
    Returns (words (B, w_act, k) uint32, sizes (B, k) int32) on that
    device: ``w_act`` is the JAX package's count of populated rows,
    ``min(ceil((max(sizes) // 32 + 2) / 16) * 16, W)``.

    ``lazy=True`` launches B2, queues the d2h of the (B, k) sizes and
    returns a zero-argument ``collect`` (the JAX package's,
    ``pl_coder.py:812-824``): it waits for those sizes, computes ``w_act``
    on the host and copies only word rows ``[:w_act]``, behind this call's
    kernel and not behind the kernels queued after it, and returns host
    numpy (words uint32, sizes int32). On the CPU the plain version has
    already run. Callers dispatch every chunk and then collect them in
    order (``frame._encode_dispatch_pl``), so every chunk's words are on the
    card at once: W * k * 4 bytes a block at the worst-case bound W, about
    L/8 of its raw bytes plus two guard rows (1.03x at 16 MiB blocks and
    L=8, 1.5x at 128 KiB blocks and L=11: at most 768 MiB for a 512 MiB
    call, well inside an 80 GB card)."""
    B = blocks.shape[0]
    dev = blocks.device
    if tables is None:
        tables = tables_from_norm(norm_tables, L, dev, host_tables,
                                  half="encode")
    words, sizes = encode_call(blocks, tables, k=k, L=L, W=W)
    if not lazy:
        if B == 0:
            return words[:, :0], sizes
        return words[:, :_w_act(int(sizes.max()), W)], sizes
    after = launched(dev)
    first = d2h([sizes], after)

    def collect():
        (s,) = first.get()
        w_act = _w_act(int(s.max()), W) if B else 0
        (words_h,) = d2h([words[:, :w_act]], after, 1).get()
        return words_h, s

    return collect


# ---------------------------------------------------------------------------
# The JAX package's public lane entries (prebuilt tables, numpy or tensors)
# ---------------------------------------------------------------------------


def _entry_rows(rows, dtype, dev: torch.device, width: int) -> torch.Tensor:
    """(B, width) rows on ``dev`` from one 2-D array or tensor, or from a
    sequence of B 1-D rows (the JAX entries index ``tables[b]``)."""
    if isinstance(rows, (np.ndarray, torch.Tensor)):
        return entry_tensor(rows, dtype, dev)
    rows = list(rows)
    if any(isinstance(r, torch.Tensor) for r in rows):
        t = torch.stack([signed_view(entry_tensor(r, dtype, dev))
                         for r in rows])
        return t.view(rows[0].dtype)
    return entry_tensor(np.stack([np.asarray(r, dtype) for r in rows]) if rows
                        else np.zeros((0, width), dtype), dtype, dev)


def _enc_parts(enc_tables) -> tuple:
    """(table, tt_bits, tt_fs) of ``encode_lanes``' ``enc_tables``: each a
    stacked 2-D array or tensor, or a tuple of B rows."""
    if len(enc_tables) == 3 and all(
            isinstance(t, (np.ndarray, torch.Tensor)) and t.ndim == 2
            for t in enc_tables):
        return tuple(enc_tables)
    return tuple(zip(*enc_tables)) or ((), (), ())


def decode_lanes(words, sizes, packed_tables, *, k: int, L: int, R: int,
                 device=None):
    """Decode B blocks of k per-lane streams (the JAX package's
    ``ops.decode_lanes``, ``pl_coder.py:1004``).

    words: (B, W, k) uint32 lane words; rows past a lane's stream are zero
      and no guard rows are needed (B1 and its plain version read rows
      outside [0, W) as zero; the JAX entry pads W to a multiple of 8 for
      the TPU's layout, which changes no byte).
    sizes: (B, k) int32 per-lane stream lengths in bits.
    packed_tables: (B, 2^L) uint32 decode entries (``sym << 24 | nb << 16
      | base``, the ``spec.fse`` ``DecodeTable.packed`` layout), or a
      sequence of B such rows.
    device: where to run (``unsigned.entry_device``): a CUDA device launches B1
      once, ``"cpu"`` runs its plain version.
    Returns (syms (B, R, k) uint8, finals (B, k) uint8) on that device;
    raises ValueError on a corrupt stream (any lane cursor not exactly
    drained) and on a bad shape."""
    dev = entry_device(device, words, sizes, packed_tables)
    words = entry_tensor(words, np.uint32, dev)
    sizes = entry_tensor(sizes, np.int32, dev)
    dec = _entry_rows(packed_tables, np.uint32, dev, 1 << L)
    return decode_lanes_norm(words, sizes, None, k=k, L=L, R=R,
                             tables=LaneTables(dec, None, None, None))


def encode_lanes(syms, init_syms, enc_tables, *, k: int, L: int, W: int,
                 device=None):
    """Encode B blocks of k per-lane streams (the JAX package's
    ``ops.encode_lanes``, ``pl_coder.py:1406``).

    syms: (B, R, k) uint8, R >= 1: round r, lane i is byte r*k + i.
    init_syms: (B, k) uint8: each lane's last byte (folded into the
      initial state).
    enc_tables: a sequence of B ``(table, tt_bits, tt_fs)`` tuples in the
      ``spec.fse`` layout (``table`` (2^L,) uint16, ``tt_bits`` (256,)
      uint32, ``tt_fs`` (256,) int32), or those three stacked as (B, .)
      arrays or tensors.
    W: word rows to allocate (``encode_w_bound(R, L)``); fewer than
      (R+1)*L bits a lane raise ValueError.
    device: as in ``decode_lanes``: one B2 launch on CUDA, its plain
      version on the CPU.
    Returns (words (B, w_act, k) uint32, sizes (B, k) int32) on that
    device, with the JAX entry's trim ``w_act = min((max(sizes) + 31) //
    32 + 1, W)``; words past each lane's stream are zero. The block B2
    reads, ``syms`` then ``init_syms`` a block, is put together on the
    device."""
    parts = _enc_parts(enc_tables)
    dev = entry_device(device, syms, init_syms, parts)
    syms = entry_tensor(syms, np.uint8, dev)
    init_syms = entry_tensor(init_syms, np.uint8, dev)
    if syms.dim() != 3 or syms.shape[2] != k:
        raise ValueError(f"syms has shape {tuple(syms.shape)}, want "
                         f"(B, R, {k})")
    B, R = syms.shape[:2]
    _check(init_syms, "init_syms", (B, k), torch.uint8, dev)
    table, tt_bits, tt_fs = (
        _entry_rows(part, dtype, dev, width) for part, dtype, width in
        zip(parts, (np.uint16, np.uint32, np.int32), (1 << L, 256, 256)))
    blocks = torch.cat([syms.reshape(B, R * k), init_syms], 1)
    words, sizes = encode_call(blocks, LaneTables(None, tt_bits, tt_fs, table),
                               k=k, L=L, W=W)
    w_act = min((int(sizes.max()) + 31) // 32 + 1, W) if B else 0
    return signed_view(words[:, :w_act]).contiguous().view(torch.uint32), sizes


# ---------------------------------------------------------------------------
# Host-side lane split/merge (wire <-> padded (W, k) layout), C++ only
# ---------------------------------------------------------------------------


def lane_merge_batch(words: np.ndarray, sizes_bits: np.ndarray,
                     pack_bits: bool = False) -> list[bytes]:
    """Batched lane merge of a block group: ``words (B, W, k)`` uint32,
    ``sizes_bits (B, k)`` -> one wire payload per block (byte-aligned lanes,
    or bit-packed with ``pack_bits``), in one OpenMP-parallel native call."""
    return native.lane_merge_batch(np.asarray(words), np.asarray(sizes_bits),
                                   pack_bits)


def lane_split_batch(payloads, sizes_bits: np.ndarray, k: int, W: int,
                     pack_bits: bool = False) -> np.ndarray:
    """Inverse of ``lane_merge_batch``: the group's ``(B, W, k)`` uint32
    kernel layout from its wire payloads, in one native call."""
    return native.lane_split_batch(payloads, np.asarray(sizes_bits), k, W,
                                   pack_bits)


def _split_sizes(sizes_bits, k: int) -> tuple[np.ndarray, int]:
    """(sizes as int64, W) of a single-block split: W is the longest lane's
    words plus two guard rows (the JAX package's). The JAX entries assert
    the sizes' shape; here a wrong shape raises ValueError."""
    sizes_bits = np.asarray(sizes_bits, np.int64)
    if sizes_bits.shape != (k,):
        raise ValueError(f"sizes_bits has shape {sizes_bits.shape}, want "
                         f"({k},)")
    return sizes_bits, int((int(sizes_bits.max()) + 31) // 32) + 2


def lane_split(payload: bytes, sizes_bits: np.ndarray, k: int):
    """Split one block's wire payload of byte-aligned concatenated lane
    streams into the padded (W, k) uint32 array B1 reads. Returns (words,
    W); ValueError when the payload is shorter than the sizes claim."""
    sizes_bits, W = _split_sizes(sizes_bits, k)
    if int(((sizes_bits + 7) // 8).sum()) > len(payload):
        raise ValueError("lane payload too short")
    return native.lane_split_batch([bytes(payload)], sizes_bits[None], k,
                                   W)[0], W


def lane_merge(words: np.ndarray, sizes_bits: np.ndarray) -> bytes:
    """Inverse of ``lane_split``: compact one block's padded (W, k) words
    into byte-aligned concatenated lane streams."""
    words = np.asarray(words)
    return native.lane_merge_batch(words[None], np.asarray(sizes_bits)[None],
                                   False)[0]


def lane_merge_bits(words: np.ndarray, sizes_bits: np.ndarray) -> bytes:
    """Bit-packed lane merge of one block (frame FLAG_PACKED): the lane
    streams concatenate at bit granularity, without the <= 7 dead bits a
    byte-aligned lane carries."""
    words = np.asarray(words)
    return native.lane_merge_batch(words[None], np.asarray(sizes_bits)[None],
                                   True)[0]


def lane_split_bits(payload: bytes, sizes_bits: np.ndarray, k: int):
    """Inverse of ``lane_merge_bits`` into the padded (W, k) uint32 layout.
    Returns (words, W); ValueError when the payload is shorter than the
    sizes claim."""
    sizes_bits, W = _split_sizes(sizes_bits, k)
    if (int(sizes_bits.sum()) + 7) // 8 > len(payload):
        raise ValueError("packed lane payload too short")
    return native.lane_split_batch([bytes(payload)], sizes_bits[None], k, W,
                                   True)[0], W

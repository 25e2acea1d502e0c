"""tANS table construction on the device, PyTorch + CUDA.

Counterpart of ``entropy_coders_tpu/ops/tables.py``. The reference builds
its tables with a serial position-chasing loop; the JAX module vectorises
it, and the plain PyTorch versions here keep that formulation, batched over
``(B, 256)`` normalized counts that share one table log:

* the spread visits the fixed positions ``(j * step) & (size - 1)``; the
  "skip the low-probability area" rule is a filter on that sequence, so the
  slot assignment is a masked scatter, and the symbol of the r-th valid
  position is a ``searchsorted`` over the cumulative counts;
* the reference's per-slot ``cumul[sym]++`` / ``symbol_next[sym]++``
  counters are stable ranks: one stable sort of the slot symbols
  (``torch.sort(stable=True)``) replaces both;
* the symbol transforms are 256-wide elementwise integer ops.

``spread_symbols_dev``, ``build_encode_table`` and ``build_decode_table``
carry the JAX names and take one ``(256,)`` table or a ``(B, 256)`` batch.
``build_tables`` is the wrapper of the hand-written kernel D3
(``csrc/tables.cu``, ``ect_build_tables``): one CTA per block fills all four
arrays of ``pl_coder.LaneTables``. It launches the kernel for CUDA tensors
(and raises if it cannot) and runs the plain versions for CPU tensors;
``TABLE_LAUNCHES`` counts the launches. Both are byte-identical to
``native.build_encode_tables`` / ``build_decode_tables`` for L = 5..15.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import TABLE_LOG_MAX, TABLE_LOG_MIN
from ..kernels.launch import check as _check, launch as _launch
from .unsigned import int64_to_u32

__all__ = [
    "TABLE_LAUNCHES",
    "build_decode_table",
    "build_encode_table",
    "build_tables",
    "build_tables_ref",
    "check_norm_tables",
    "spread_symbols_dev",
]

ALPHABET = 256
TABLE_LAUNCHES = 0  # D3 launches since import (or since a caller reset it)


def _ilog2(x: torch.Tensor) -> torch.Tensor:
    """Elementwise floor(log2(x)) for int64 values in [1, 2**16]."""
    out = torch.zeros_like(x)
    for k in range(1, 17):
        out += (x >= (1 << k)).to(x.dtype)
    return out


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, -1) - x


def _to_u16(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^16) -> a torch.uint16 tensor of those values."""
    return torch.where(t >= 1 << 15, t - (1 << 16), t).to(torch.int16).view(
        torch.uint16)


def _batched(norm_table) -> tuple[torch.Tensor, bool]:
    """(counts (B, 256) int64, whether the input was one (256,) table)."""
    t = torch.as_tensor(norm_table)
    single = t.dim() == 1
    t = t.reshape(-1, ALPHABET) if single else t
    if t.dim() != 2 or t.shape[1] != ALPHABET:
        raise ValueError(f"norm_table must be (256,) or (B, 256), got "
                         f"{tuple(t.shape)}")
    return t.to(torch.int64), single


def _spread(counts: torch.Tensor, log2: int):
    """Slot -> symbol map (B, size) int64 and high_threshold (B,) of the
    batched int64 counts."""
    size = 1 << log2
    B = counts.shape[0]
    dev = counts.device
    low = counts == -1
    low_i = low.to(torch.int64)
    high_threshold = size - 1 - low_i.sum(1)

    # column `size` takes what the JAX scatter drops
    symbols = torch.zeros((B, size + 1), dtype=torch.int64, device=dev)
    # low-probability symbols walk down from the table top in symbol order
    low_slot = torch.where(low, size - 1 - _exclusive_cumsum(low_i), size)
    symbols.scatter_(1, low_slot.clamp(0, size),
                     torch.arange(ALPHABET, device=dev).expand(B, ALPHABET))

    # run-length decode the spread symbol sequence
    spread_counts = torch.where(low, 0, counts.clamp(min=0))
    cum = torch.cumsum(spread_counts, 1)
    ranks = torch.arange(size, device=dev)
    sym_seq = torch.searchsorted(cum, ranks.expand(B, size).contiguous(),
                                 right=True).clamp(max=ALPHABET - 1)

    step = size * 5 // 8 + 3
    positions = (ranks * step) & (size - 1)
    valid = positions[None] <= high_threshold[:, None]
    rank = _exclusive_cumsum(valid.to(torch.int64))
    symbols.scatter_(1, torch.where(valid, positions[None], size),
                     torch.gather(sym_seq, 1, rank))
    return symbols[:, :size].contiguous(), high_threshold


def spread_symbols_dev(norm_table, *, log2: int):
    """Slot -> symbol map, the common core of both tables: ``(symbols
    int32, high_threshold)`` of one ``(256,)`` table or a ``(B, 256)``
    batch."""
    counts, single = _batched(norm_table)
    symbols, ht = _spread(counts, log2)
    symbols = symbols.to(torch.int32)
    return (symbols[0], ht[0]) if single else (symbols, ht)


def _encode_table(counts: torch.Tensor, symbols: torch.Tensor, log2: int):
    size, L = 1 << log2, log2
    # next-state table: stable sort of slots by symbol == the reference's
    # cumul[] fill
    order = torch.sort(symbols, dim=1, stable=True).indices
    table = _to_u16(size + order)

    is_pm1 = (counts == -1) | (counts == 1)
    is_big = counts > 1
    contrib = torch.where(is_pm1, 1, torch.where(is_big, counts, 0))
    total_before = _exclusive_cumsum(contrib)

    # count > 1
    mbo = L - _ilog2((counts - 1).clamp(min=1))
    msp = (counts << mbo) & 0xFFFFFFFF
    bits_big = ((mbo << 16) - msp) & 0xFFFFFFFF
    fs_big = total_before - counts
    # count == +-1, count == 0
    bits_pm1 = ((L << 16) - (1 << L)) & 0xFFFFFFFF
    fs_pm1 = total_before - 1
    bits_zero = (((L + 1) << 16) - (1 << L)) & 0xFFFFFFFF

    tt_bits = torch.where(is_big, bits_big,
                          torch.where(is_pm1, bits_pm1, bits_zero))
    tt_fs = torch.where(is_big, fs_big, torch.where(is_pm1, fs_pm1, 0))
    # the reference only fills transforms for symbols < table_len; later
    # symbols keep the default (0)
    sym_ids = torch.arange(ALPHABET, device=counts.device)
    table_len = torch.where(counts != 0, sym_ids, -1).amax(1) + 1
    in_range = sym_ids[None] < table_len[:, None]
    tt_bits = torch.where(in_range, tt_bits, 0)
    tt_fs = torch.where(in_range, tt_fs, 0)
    return table, int64_to_u32(tt_bits), tt_fs.to(torch.int32)


def build_encode_table(norm_table, *, log2: int):
    """``(table uint16, tt_bits uint32, tt_find_state int32)`` of one
    ``(256,)`` table or a ``(B, 256)`` batch."""
    counts, single = _batched(norm_table)
    out = _encode_table(counts, _spread(counts, log2)[0], log2)
    return tuple(t[0] for t in out) if single else out


def _decode_table(counts: torch.Tensor, symbols: torch.Tensor, log2: int):
    size, L = 1 << log2, log2
    B = counts.shape[0]
    dev = counts.device
    start_of = torch.where(counts == -1, 1, counts)

    order = torch.sort(symbols, dim=1, stable=True).indices
    inv_rank = torch.zeros((B, size), dtype=torch.int64, device=dev).scatter_(
        1, order, torch.arange(size, device=dev).expand(B, size))
    group_sizes = torch.zeros((B, ALPHABET), dtype=torch.int64,
                              device=dev).scatter_add_(
        1, symbols, torch.ones_like(symbols))
    group_starts = _exclusive_cumsum(group_sizes)
    within = inv_rank - torch.gather(group_starts, 1, symbols)

    next_state = torch.gather(start_of, 1, symbols) + within
    nb = L - _ilog2(next_state.clamp(min=1))
    new_state = ((next_state << nb) - size) & 0xFFFF
    return int64_to_u32((symbols << 24) | (nb << 16) | new_state)


def build_decode_table(norm_table, *, log2: int):
    """The packed decode table ``symbol << 24 | num_bits << 16 | new_state``
    as uint32, of one ``(256,)`` table or a ``(B, 256)`` batch."""
    counts, single = _batched(norm_table)
    packed = _decode_table(counts, _spread(counts, log2)[0], log2)
    return packed[0] if single else packed


def check_norm_tables(norm_tables: np.ndarray, L: int) -> np.ndarray:
    """The host checks of ``native.build_*_tables`` on (B, 256) normalized
    counts, before they go to the card: a table log in 5..15, every count
    in [-1, 2^L], the slots summing to 2^L, at least two symbols' worth of
    table. Returns the contiguous int32 array; raises ValueError."""
    nt = np.ascontiguousarray(norm_tables, np.int32)
    if nt.ndim != 2 or nt.shape[1] != ALPHABET:
        raise ValueError(f"norm_tables must be (B, 256), got {nt.shape}")
    if not TABLE_LOG_MIN <= L <= TABLE_LOG_MAX:
        raise ValueError(f"table build failed: table log {L} out of range")
    slots = np.where(nt == -1, 1, nt).astype(np.int64).sum(1)
    nz = nt != 0
    table_len = np.where(nz.any(1), ALPHABET - np.argmax(nz[:, ::-1], 1), 1)
    if ((nt < -1) | (nt > 1 << L)).any() or (slots != 1 << L).any() \
            or (table_len < 2).any():
        raise ValueError("table build failed: not a normalization to "
                         f"2^{L} slots")
    return nt


def build_tables_ref(norm: torch.Tensor, L: int):
    """Plain PyTorch version of D3 (same inputs and outputs as
    ``build_tables``)."""
    counts = norm.to(torch.int64)
    symbols = _spread(counts, L)[0]
    next_state, tt_bits, tt_fs = _encode_table(counts, symbols, L)
    return _decode_table(counts, symbols, L), tt_bits, tt_fs, next_state


def build_tables(norm: torch.Tensor, L: int):
    """All four table arrays of B blocks at table log ``L`` (D3's wrapper).

    norm: (B, 256) int32 normalized counts, a valid normalization to 2^L
      slots (``check_norm_tables`` checks it on the host).
    Returns ``(dec (B, 2^L) uint32, tt_bits (B, 256) uint32, tt_fs (B, 256)
    int32, next_state (B, 2^L) uint16)``, the fields of
    ``pl_coder.LaneTables`` in order.

    A CUDA tensor launches D3 (and raises if the launch fails); a CPU
    tensor runs ``build_tables_ref``."""
    global TABLE_LAUNCHES
    if norm.dim() != 2:
        raise ValueError(f"norm must be (B, 256), got {tuple(norm.shape)}")
    B = norm.shape[0]
    dev = norm.device
    if not TABLE_LOG_MIN <= L <= TABLE_LOG_MAX:
        raise ValueError(f"bad table log {L}")
    _check(norm, "norm", (B, ALPHABET), torch.int32, dev)
    if dev.type == "cpu":
        return build_tables_ref(norm, L)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    size = 1 << L
    dec = torch.empty((B, size), dtype=torch.int32, device=dev).view(
        torch.uint32)
    tt_bits = torch.empty((B, ALPHABET), dtype=torch.int32, device=dev).view(
        torch.uint32)
    tt_fs = torch.empty((B, ALPHABET), dtype=torch.int32, device=dev)
    next_state = torch.empty((B, size), dtype=torch.int16, device=dev).view(
        torch.uint16)
    if B == 0:
        return dec, tt_bits, tt_fs, next_state
    from ..kernels.build import load

    lib = load()
    with torch.cuda.device(dev):
        _launch(lib.ect_build_tables, norm.data_ptr(), dec.data_ptr(),
                next_state.data_ptr(), tt_bits.data_ptr(), tt_fs.data_ptr(),
                B, L, torch.cuda.current_stream(dev).cuda_stream)
    TABLE_LAUNCHES += 1
    return dec, tt_bits, tt_fs, next_state

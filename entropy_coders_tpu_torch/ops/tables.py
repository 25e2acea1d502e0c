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
(``csrc/tables.cu``, ``ect_build_tables``): it builds the half of
``pl_coder.LaneTables`` its caller reads (``half="decode"``: ``dec``;
``"encode"``: ``tt_bits``, ``tt_fs``, ``next_state``) or both, each table
by a thread-block cluster of ``launch_config``'s size. It launches the
kernel for CUDA tensors (and raises if it cannot) and runs the plain
versions for CPU tensors; ``TABLE_LAUNCHES`` counts the launches. Both are
byte-identical to ``native.build_encode_tables`` /
``build_decode_tables`` for L = 5..15.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import TABLE_LOG_MAX, TABLE_LOG_MIN
from ..kernels.launch import check as _check, launch as _launch
from .unsigned import int64_to_u32

__all__ = [
    "HALF_FIELDS",
    "HALVES",
    "TABLE_LAUNCHES",
    "build_decode_table",
    "build_encode_table",
    "build_tables",
    "build_tables_ref",
    "check_norm_tables",
    "cluster_choices",
    "half_code",
    "launch_config",
    "spread_symbols_dev",
]

ALPHABET = 256
TABLE_LAUNCHES = 0  # D3 launches since import (or since a caller reset it)
# the halves a build can ask for, as the kernel's `half` argument, and the
# fields of pl_coder.LaneTables each one builds
HALVES = {"decode": 1, "encode": 2, "both": 3}
HALF_FIELDS = {"decode": ("dec",),
               "encode": ("tt_bits", "tt_fs", "next_state"),
               "both": ("dec", "tt_bits", "tt_fs", "next_state")}


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


def half_code(half: str) -> int:
    """The kernel's code of a half (``HALVES``); ValueError for another
    name."""
    if half not in HALVES:
        raise ValueError(f"half must be one of {tuple(HALVES)}, got {half!r}")
    return HALVES[half]


def build_tables_ref(norm: torch.Tensor, L: int, half: str = "both"):
    """Plain PyTorch version of D3 (same inputs and outputs as
    ``build_tables``)."""
    want = half_code(half)
    counts = norm.to(torch.int64)
    symbols = _spread(counts, L)[0]
    dec = _decode_table(counts, symbols, L) if want & 1 else None
    if not want & 2:
        return dec, None, None, None
    next_state, tt_bits, tt_fs = _encode_table(counts, symbols, L)
    return dec, tt_bits, tt_fs, next_state


def launch_config(B: int, L: int, n_sm: int,
                  cluster: int | None = None) -> tuple[int, int]:
    """(C, T) that D3 launches with for B tables at table log L on a card
    of ``n_sm`` SMs: each table is built by a cluster of C CTAs of T
    threads. C (unless ``cluster`` names it) doubles, up to 8 (the portable
    cluster size), while the B * C CTAs still fit one to an SM and each CTA
    keeps at least 1,024 slots: a few tables at a large L spread over
    several SMs, and many tables (the default point's ~1,022 at L = 10)
    take one CTA each. T is a thread a slot of the CTA, within 128..512,
    halved (down to 128) while the B * C CTAs would take more than half of
    the card's threads (1,024 of an SM's 2,048). On an H100 (NVIDIA H100
    80GB HBM3, 700 W; ``tools/device_host.py --sweep``, the kernel alone)
    these picks were the fastest of every cluster and CTA size at each
    main-path shape: B = 4-8 at L = 8 and 11, 512 and 1,022 at L = 10, 4 at
    L = 15."""
    size = 1 << L
    C = cluster
    if C is None:
        C = 1
        while C < 8 and 2 * C * B <= n_sm and size // (2 * C) >= 1024:
            C *= 2
    T = min(512, max(128, size // C))
    while T > 128 and B * C * T > n_sm * 1024:
        T //= 2
    return C, T


def cluster_choices(L: int) -> list:
    """The cluster sizes ``launch_config`` can pick at table log L, for
    some B and SM count: 1, and each of 2, 4, 8 that leaves a CTA 1,024
    slots or more."""
    return [c for c in (1, 2, 4, 8) if c == 1 or (1 << L) // c >= 1024]


_SMS: dict = {}   # device index -> SM count
_FNS = None       # (ect_build_tables, ect_build_tables_empty), looked up once


def _launchers():
    global _FNS
    if _FNS is None:
        from ..kernels.build import load

        lib = load()
        _FNS = (lib.ect_build_tables, lib.ect_build_tables_empty)
    return _FNS


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _outputs(B: int, L: int, want: int, dev: torch.device):
    """The half's arrays, (dec, tt_bits, tt_fs, next_state) with None where
    not built: one ``torch.empty``, and for the encode half 16-byte
    aligned strided views into it (each a view op: on a slow host a tensor
    op costs microseconds, which is what a call at the main path's shapes
    is made of)."""
    size = 1 << L
    if want == 1:
        return (torch.empty((B, size), dtype=torch.uint32, device=dev), None,
                None, None)
    n_dec = B * size if want & 1 else 0  # in 4-byte words
    at_bits = n_dec + B * size // 2
    buf = torch.empty(at_bits + 2 * B * ALPHABET, dtype=torch.int32,
                      device=dev)
    u32 = buf.view(torch.uint32)
    return (u32.as_strided((B, size), (size, 1), 0) if want & 1 else None,
            u32.as_strided((B, ALPHABET), (ALPHABET, 1), at_bits),
            buf.as_strided((B, ALPHABET), (ALPHABET, 1), at_bits + B * ALPHABET),
            buf.view(torch.uint16).as_strided((B, size), (size, 1), 2 * n_dec))


def build_tables(norm: torch.Tensor, L: int, half: str = "both",
                 cluster: int | None = None, *, threads: int | None = None,
                 empty: bool = False):
    """The table arrays of B blocks at table log ``L`` (D3's wrapper).

    norm: (B, 256) int32 normalized counts, a valid normalization to 2^L
      slots (``check_norm_tables`` checks it on the host).
    half: ``"decode"`` builds ``dec`` only, ``"encode"`` ``tt_bits``,
      ``tt_fs`` and ``next_state`` only, ``"both"`` all four.
    cluster, threads: the CTAs a table (1, 2, 4 or 8) and the threads a
      CTA (128, 256 or 512); None takes ``launch_config``'s pick for this
      card.
    Returns ``(dec (B, 2^L) uint32, tt_bits (B, 256) uint32, tt_fs (B, 256)
    int32, next_state (B, 2^L) uint16)``, the fields of
    ``pl_coder.LaneTables`` in order, None for each array of the half not
    built.

    A CUDA tensor launches D3 (and raises if the launch fails, a cluster
    the runtime refuses included); a CPU tensor runs ``build_tables_ref``.
    ``empty=True`` launches a kernel that does nothing, with D3's grid,
    cluster, threads and shared memory (the floor of such a launch), and
    leaves the outputs unwritten."""
    global TABLE_LAUNCHES
    want = half_code(half)
    if norm.dim() != 2:
        raise ValueError(f"norm must be (B, 256), got {tuple(norm.shape)}")
    B = norm.shape[0]
    dev = norm.device
    if not TABLE_LOG_MIN <= L <= TABLE_LOG_MAX:
        raise ValueError(f"bad table log {L}")
    _check(norm, "norm", (B, ALPHABET), torch.int32, dev)
    if cluster is not None and (cluster not in (1, 2, 4, 8)
                                or (1 << L) // cluster < 32):
        raise ValueError(f"bad cluster size {cluster} at table log {L}")
    if threads not in (None, 128, 256, 512):
        raise ValueError(f"bad CTA size {threads}")
    if dev.type == "cpu":
        return build_tables_ref(norm, L, half)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _outputs(B, L, want, dev)
    if B == 0:
        return out
    C, T = launch_config(B, L, _sm_count(dev), cluster)
    T = threads or T
    p_dec, p_bits, p_fs, p_next = (0 if t is None else t.data_ptr()
                                   for t in out)
    args = (norm.data_ptr(), p_dec, p_next, p_bits, p_fs, B, L, want, C, T)
    fn = _launchers()[1 if empty else 0]
    # the raw pointer of the device's current stream, without a Stream
    # object (what Triton's launcher reads too)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        _launch(fn, *args, stream)
    else:
        with torch.cuda.device(dev):
            _launch(fn, *args, stream)
    if not empty:
        TABLE_LAUNCHES += 1
    return out

"""Per-lane decode with a pluggable table entry format (kernels B4/B5).

Counterpart of the JAX package's ``tools/l10_attack_harness.py``: B1's lane
decode (``ops.pl_coder.decode_call``) with the table lookup made pluggable,
so that table layouts can be measured without touching B1. On the TPU an
``entry_fn(tbl, states, S, L) -> (nb, base, sym)`` picked the layout of the
gather rows; here the layout picks how the block's table is stored in shared
memory and unpacked, one instantiation of B1's own kernel
(``csrc/lane_decode.cuh``, launched from ``csrc/pl_decode_layout.cu``) per
layout, with B1's CTA size and refill group (``PL.lane_config``). The
layouts (``LAYOUTS``), bytes per entry, and the JAX ``entry_fn`` each one
follows:

* ``flat`` (4): u32 sym << 24 | nb << 16 | base, B1's own, the control
  (``ops/pl_coder.py:329-330``);
* ``split`` (3): a u16 nb << 12 | base plane and a u8 sym plane, L <= 12
  (``ops/pl_coder.py:318-328``);
* ``upack`` (2): u16 sym << 9 | u, u the spread-source state; nb = L -
  ilog2(u), base = (u << nb) - 2^L; only where ``upack_ok``
  (``ops/pl_coder.py:306-317``);
* ``fused`` (4): u32 sym << (L + 4) | nb << L | base
  (``tools/l10_attack.py:234-248``);
* ``nosym`` (2): the u16 nb << 12 | base plane alone, sym = that word &
  0xFF: WRONG BYTES BY DESIGN, the bound for any layout that still fetches
  (nb, base); L <= 12 (``tools/l10_attack.py:221-227``).

``layout_tables`` turns the flat ``LaneTables.dec`` into a layout's planes,
``decode_lanes_layout`` is the kernel's wrapper (CUDA tensors launch the
kernel, CPU tensors run ``decode_lanes_layout_ref``), and
``LAYOUT_LAUNCHES`` counts launches per layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pl_coder import _aligned, _check, _launch, _read_bits, lane_config
from ..ops.unsigned import as_int64

__all__ = [
    "LAYOUTS",
    "LAYOUT_LAUNCHES",
    "decode_lanes_layout",
    "decode_lanes_layout_ref",
    "layout_applies",
    "layout_occupancy",
    "layout_tables",
    "table_bytes",
    "upack_ok",
]

LAYOUTS = ("flat", "split", "upack", "fused", "nosym")
# the kernel's `layout` argument (csrc/pl_decode_layout.cu enum Layout)
_CODE = {name: i for i, name in enumerate(LAYOUTS)}
# plane dtypes of each layout, each plane (B, 2^L)
_PLANES = {"flat": (torch.uint32,), "split": (torch.uint16, torch.uint8),
           "upack": (torch.uint16,), "fused": (torch.uint32,),
           "nosym": (torch.uint16,)}
_BYTES = {"flat": 4, "split": 3, "upack": 2, "fused": 4, "nosym": 2}
_MAX_L = {"flat": 15, "split": 12, "upack": 15, "fused": 15, "nosym": 12}

LAYOUT_LAUNCHES = dict.fromkeys(LAYOUTS, 0)  # kernel launches per layout

# floor(log2(u)) for the 9-bit u of an upack entry (-1 for u = 0, as the
# kernel's 31 - __clz(0))
_ILOG2 = torch.tensor([-1] + [int(u).bit_length() - 1 for u in range(1, 512)],
                      dtype=torch.int64)


def table_bytes(layout: str, L: int) -> int:
    """Shared-memory bytes of one block's table in ``layout``."""
    return _BYTES[_layout(layout)] << L


def _layout(layout: str) -> str:
    if layout not in _CODE:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    return layout


def _check_L(layout: str, L: int) -> None:
    if not 5 <= L <= _MAX_L[layout]:
        raise ValueError(f"layout {layout!r} takes table logs "
                         f"5..{_MAX_L[layout]}, not {L}")


def upack_ok(norm_tables: np.ndarray, L: int) -> bool:
    """Batch-wide eligibility for ``upack``, the rule of the JAX package's
    ``upack_ok`` (``ops/pl_coder.py:130-146``): every coded symbol < 128
    and every spread-source state u < 512, i.e. no normalized count over
    256 (structural at L <= 8)."""
    nt = np.asarray(norm_tables)
    if nt[:, 128:].any():
        return False
    return L <= 8 or int(nt.max()) <= 256


def layout_applies(layout: str, norm_tables: np.ndarray, L: int) -> bool:
    """Whether ``layout`` takes the tables normalized to ``norm_tables``
    at table log ``L`` (the JAX package's gates: ``split``/``nosym`` up to
    L = 12, ``upack`` where ``upack_ok``)."""
    if not 5 <= L <= _MAX_L[_layout(layout)]:
        return False
    return layout != "upack" or upack_ok(norm_tables, L)


def _to_unsigned(t: torch.Tensor, dtype) -> torch.Tensor:
    """int64 values in [0, 2^bits) -> a tensor of the unsigned ``dtype``
    (through an exact cast to the signed type of that width)."""
    if dtype == torch.uint8:
        return t.to(torch.uint8)
    bits, signed = {torch.uint16: (16, torch.int16),
                    torch.uint32: (32, torch.int32)}[dtype]
    return torch.where(t >= 1 << (bits - 1), t - (1 << bits), t).to(
        signed).view(dtype)


def layout_tables(dec: torch.Tensor, L: int, layout: str):
    """The flat (B, 2^L) u32 decode entries (sym << 24 | nb << 16 | base,
    ``LaneTables.dec``) -> the tuple of ``layout``'s planes, each (B, 2^L),
    on ``dec``'s device. Raises ValueError where the JAX package refuses
    the layout: ``split``/``nosym`` above L = 12, ``upack`` on a table
    with a symbol >= 128 or a state u >= 512 (``upack_ok_packed``)."""
    layout = _layout(layout)
    _check_L(layout, L)
    if dec.dim() != 2 or dec.shape[1] != 1 << L or dec.dtype != torch.uint32:
        raise ValueError(f"dec must be (B, {1 << L}) uint32, got "
                         f"{tuple(dec.shape)} {dec.dtype}")
    if layout == "flat":
        return (dec.contiguous(),)
    e = as_int64(dec)
    sym, nb, base = e >> 24, (e >> 16) & 0xFF, e & 0xFFFF
    if layout in ("split", "nosym"):
        half = _to_unsigned((nb << 12) | base, torch.uint16)
        return (half,) if layout == "nosym" else (half, sym.to(torch.uint8))
    if layout == "fused":
        fused = (sym << (L + 4)) | (nb << L) | base
        return (_to_unsigned(fused, torch.uint32),)
    u = (base + (1 << L)) >> nb
    if not (bool((sym < 128).all()) and bool(((u >= 1) & (u < 512)).all())
            and bool(((u << nb) == base + (1 << L)).all())):
        raise ValueError(f"upack does not apply: a symbol >= 128 or a state "
                         f"u >= 512 at L={L}")
    return (_to_unsigned((sym << 9) | u, torch.uint16),)


def _entries(layout: str, table, L: int):
    """entry(state) -> (nb, base, sym) int64 for the plain version: the
    unpack step of ``layout``, as the kernel's ``entry<LAYOUT>``."""
    planes = [as_int64(p) for p in table]
    p0 = planes[0]

    def entry(state):
        v = torch.gather(p0, 1, state)
        if layout == "flat":
            return (v >> 16) & 0xFF, v & 0xFFFF, v >> 24
        if layout == "split":
            return v >> 12, v & 0xFFF, torch.gather(planes[1], 1, state)
        if layout == "upack":
            u = v & 0x1FF
            nb = L - _ILOG2.to(v.device)[u]
            return nb, (u << nb) - (1 << L), v >> 9
        if layout == "fused":
            return (v >> L) & 0xF, v & ((1 << L) - 1), (v >> (L + 4)) & 0xFF
        return v >> 12, v & 0xFFF, v & 0xFF  # nosym

    return entry


def decode_lanes_layout_ref(words, sizes, table, *, layout: str, L: int,
                            R: int):
    """Plain PyTorch version of the layout kernel (same inputs and outputs
    as ``decode_lanes_layout``), vectorised over (B, k), a loop over R
    rounds, int64 throughout (``ops.pl_coder.decode_call_ref`` with the
    unpack step of ``layout``)."""
    B, W, k = words.shape
    w = as_int64(words)
    entry = _entries(_layout(layout), table, L)
    mask_L = (1 << L) - 1
    c = sizes.to(torch.int64) - L
    state = _read_bits(w, c, L) & mask_L
    syms = torch.empty((B, R, k), dtype=torch.uint8, device=words.device)
    for r in range(R):
        nb, base, sym = entry(state)
        c = c - nb
        state = (base + _read_bits(w, c, nb)) & mask_L
        syms[:, r] = sym.to(torch.uint8)
    finals = entry(state)[2].to(torch.uint8)
    return syms, finals, c.to(torch.int32)


def decode_lanes_layout(words, sizes, table, *, layout: str, L: int, R: int):
    """Decode B blocks of k per-lane streams with ``layout``'s table (the
    layout kernel's wrapper).

    words: (B, W, k) uint32 lane words (rows past the streams zero).
    sizes: (B, k) int32 per-lane stream lengths in bits.
    table: ``layout_tables(dec, L, layout)``, a tuple of (B, 2^L) planes.
    Returns (syms (B, R, k) uint8, finals (B, k) uint8, cursors (B, k)
    int32), as ``ops.pl_coder.decode_call``; ``nosym``'s symbols are
    wrong by design.

    CUDA tensors launch the kernel (and raise if the launch fails); CPU
    tensors run ``decode_lanes_layout_ref``."""
    layout = _layout(layout)
    if words.dim() != 3:
        raise ValueError(f"words must be (B, W, k), got {tuple(words.shape)}")
    B, W, k = words.shape
    dev = words.device
    if k % 128:
        raise ValueError(f"k={k} must be a multiple of 128")
    _check_L(layout, L)
    if R < 0:
        raise ValueError(f"bad round count {R}")
    _check(words, "words", (B, W, k), torch.uint32, dev)
    _check(sizes, "sizes", (B, k), torch.int32, dev)
    dtypes = _PLANES[layout]
    if not isinstance(table, (tuple, list)) or len(table) != len(dtypes):
        raise ValueError(f"layout {layout!r} takes {len(dtypes)} plane(s)")
    for i, (plane, dtype) in enumerate(zip(table, dtypes)):
        _check(plane, f"{layout} plane {i}", (B, 1 << L), dtype, dev)
    if dev.type == "cpu":
        return decode_lanes_layout_ref(words, sizes, table, layout=layout,
                                       L=L, R=R)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    words, sizes = _aligned(words), _aligned(sizes)
    table = tuple(map(_aligned, table))
    syms = torch.empty((B, R, k), dtype=torch.uint8, device=dev)
    finals = torch.empty((B, k), dtype=torch.uint8, device=dev)
    cursors = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return syms, finals, cursors
    from ..kernels.build import load

    lib = load()
    with torch.cuda.device(dev):
        _launch(lib.ect_pl_decode_layout, words.data_ptr(), sizes.data_ptr(),
                table[0].data_ptr(),
                table[1].data_ptr() if len(table) > 1 else None,
                syms.data_ptr(), finals.data_ptr(), cursors.data_ptr(), B, W,
                k, L, R, _CODE[layout], *lane_config("decode", k, L),
                torch.cuda.current_stream(dev).cuda_stream)
    LAYOUT_LAUNCHES[layout] += 1
    return syms, finals, cursors


def layout_occupancy(layout: str, L: int, device=None, k: int = 16384) -> int:
    """Co-resident CTAs per SM of ``layout``'s kernel at table log ``L`` for
    k lanes (the CTA size and refill group of ``PL.lane_config``) on a CUDA
    ``device``, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` with
    the kernel's shared memory: the table, the lanes' word ring and the
    symbol tiles. Raises without CUDA."""
    layout = _layout(layout)
    _check_L(layout, L)
    from ..kernels.build import load

    lib = load()
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        n = lib.ect_pl_decode_layout_occupancy(_CODE[layout], L,
                                               *lane_config("decode", k, L))
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n

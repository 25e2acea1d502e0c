"""Per-block crc32 on the card (no counterpart in the JAX package).

The JAX package checksums FLAG_CRC frames with ``zlib.crc32`` on the host, a
block at a time (``entropy_coders_tpu/frame.py:317`` on compress, ``:772``
on decompress). The port checksums the bytes it already holds on the card
(the full blocks on compress, each per-lane block as B1 decoded it on
decompress) with a kernel written for Hopper (``csrc/crc32.cu``,
``ect_crc32``): chunks of ``THREADS * SEG`` bytes, a slicing-by-16 table crc
a thread, the pieces joined over GF(2) by their zero-extension powers.
``crc32_blocks`` is its wrapper: a CUDA tensor launches the kernel (and
raises if it cannot build or launch; there is no fallback), a CPU tensor
runs the plain version, ``crc32_blocks_ref``, which repeats the kernel's
arithmetic: the same tables, segments, chunks and joins. ``CRC_LAUNCHES``
counts the launches (one ``ect_crc32`` call, two kernels, a launch).

A row is one piece, or two (``tail``): a decoded block is its symbols
``syms[j]`` (R * k bytes) then its finals ``finals[j]`` (k bytes), each
written back to a different place. Each row's value is exactly
``zlib.crc32`` of its bytes, as uint32.
"""

from __future__ import annotations

import functools

import torch

from ..kernels.launch import launch as _launch
from .unsigned import int64_to_u32

__all__ = ["CRC_LAUNCHES", "SEG", "THREADS", "crc32_blocks",
           "crc32_blocks_ref", "units"]

CRC_LAUNCHES = 0  # ect_crc32 launches since import (or since a caller reset it)
THREADS = 256     # threads a CTA of the chunk kernel
SEG = 256         # bytes a thread's segment (a multiple of 16)
POLY = 0xEDB88320
ONE = 1 << 31     # the polynomial 1, reflected
MAX_ROW = 1 << 32  # a row holds fewer bytes than this


def _mul(a: int, b: int) -> int:
    """a * b mod P, both reflected (bit 31 the coefficient of x^0)."""
    p = 0
    for i in range(32):
        if (a >> (31 - i)) & 1:
            p ^= b
        b = (b >> 1) ^ (POLY if b & 1 else 0)
    return p


def _x8() -> list[int]:
    """x^(8 * 2^i) mod P for i < 32 (the kernel's ``kX8``)."""
    x, out = 1 << 30, []  # x^1
    for i in range(35):
        if i >= 3:
            out.append(x)
        x = _mul(x, x)
    return out


X8 = _x8()


def xpow8(m: int) -> int:
    """x^(8m) mod P: ``_mul(c, xpow8(m))`` is c followed by m zero bytes."""
    r, i = ONE, 0
    while m:
        if m & 1:
            r = _mul(r, X8[i])
        m >>= 1
        i += 1
    return r


def _mul_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_mul`` over int64 tensors (broadcast)."""
    p = torch.zeros_like(a)
    b = b.expand_as(a).clone()
    for i in range(32):
        p ^= -((a >> (31 - i)) & 1) & b
        b = (b >> 1) ^ (-(b & 1) & POLY)
    return p


@functools.lru_cache(maxsize=None)
def _tables() -> torch.Tensor:
    """The 16 slicing tables, (16, 256) int64: table k is a byte followed
    by k zero bytes, from register 0."""
    t0 = []
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        t0.append(c)
    tabs = [t0]
    for _ in range(15):
        tabs.append([(c >> 8) ^ t0[c & 0xFF] for c in tabs[-1]])
    return torch.tensor(tabs, dtype=torch.int64)


def _xor_last(t: torch.Tensor) -> torch.Tensor:
    """XOR over the last dimension."""
    while t.shape[-1] > 1:
        if t.shape[-1] % 2:
            t = torch.nn.functional.pad(t, (0, 1))
        t = t[..., 0::2] ^ t[..., 1::2]
    return t[..., 0]


def units(n1: int, n2: int = 0) -> int:
    """Chunks a row of pieces of n1 and n2 bytes is cut into."""
    chunk = THREADS * SEG
    return -(-n1 // chunk) + -(-n2 // chunk)


def _piece_raw(piece: torch.Tensor, after: int) -> torch.Tensor:
    """The raw crcs (register 0, no inversion) of the (B, n) uint8 rows of
    ``piece``, each followed by ``after`` zero bytes, as the chunk kernel
    computes them: chunks of THREADS * SEG bytes, the last one shorter;
    thread t's segment ends (THREADS - 1 - t) * SEG bytes before its
    chunk's end (a short chunk is zero-padded at its front, which leaves a
    raw crc from register 0 as it is); slicing-by-16 a segment; each
    segment's crc times its power, XORed over the chunk, times the chunk's
    power, XORed over the row."""
    B, n = piece.shape
    dev = piece.device
    C = THREADS * SEG
    U = units(n)
    if U == 0:
        return torch.zeros(B, dtype=torch.int64, device=dev)
    last = n - (U - 1) * C
    padded = torch.zeros((B, U * C), dtype=torch.uint8, device=dev)
    padded[:, : (U - 1) * C] = piece[:, : (U - 1) * C]
    padded[:, U * C - last:] = piece[:, (U - 1) * C:]
    vecs = padded.view(B * U * THREADS, SEG // 16, 16)
    flat = _tables().to(dev).reshape(-1)
    pos = torch.arange(15, -1, -1, device=dev) * 256  # byte i: table 15 - i
    shifts = torch.arange(4, device=dev) * 8
    c = torch.zeros(vecs.shape[0], dtype=torch.int64, device=dev)
    for s in range(SEG // 16):
        w = vecs[:, s].to(torch.int64)
        w[:, :4] ^= (c[:, None] >> shifts) & 0xFF
        c = _xor_last(flat[w + pos])
    own = torch.tensor([xpow8((THREADS - 1 - t) * SEG)
                        for t in range(THREADS)], device=dev)
    v = _xor_last(_mul_t(c.view(B, U, THREADS), own))
    ends = [min((u + 1) * C, n) for u in range(U)]
    pows = torch.tensor([xpow8(n - e + after) for e in ends], device=dev)
    return _xor_last(_mul_t(v, pows))


def crc32_blocks_ref(rows: torch.Tensor,
                     tail: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the crc kernel: (B, n1) uint8 rows, each
    followed by its row of ``tail`` (B, n2) when given, -> (B,) uint32
    crc32s (``zlib.crc32`` of each row's bytes)."""
    n2 = 0 if tail is None else tail.shape[1]
    n = rows.shape[1] + n2
    raw = _piece_raw(rows, n2)
    if tail is not None:
        raw = raw ^ _piece_raw(tail, 0)
    fix = 0xFFFFFFFF ^ _mul(0xFFFFFFFF, xpow8(n))  # zlib's register set and
    return int64_to_u32(raw ^ fix)                 # final inversion


_CTAS: dict = {}   # device index -> CTAs of the chunk kernel resident at once


def _max_ctas(lib, dev: torch.device) -> int:
    if dev.index not in _CTAS:
        got = lib.ect_crc32_max_ctas(dev.index, THREADS)
        if got <= 0:
            raise RuntimeError(f"ect_crc32_max_ctas failed: CUDA error "
                               f"{-got}")
        _CTAS[dev.index] = got
    return _CTAS[dev.index]


def _rows(t, name: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dim() != 2 or t.dtype != torch.uint8:
        raise ValueError(f"{name} must be (B, n) uint8, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: each row's bytes must be contiguous")


def crc32_blocks(rows: torch.Tensor,
                 tail: torch.Tensor | None = None) -> torch.Tensor:
    """(B, n1) uint8 rows, each followed by its row of ``tail`` (B, n2)
    when given -> (B,) uint32 ``zlib.crc32`` of each row's bytes, on the
    rows' device (the crc kernel's wrapper). A row's bytes are contiguous;
    rows may lie any distance apart. A CUDA tensor launches the kernel on
    its device's current stream (raising if it cannot build or launch) and
    reads nothing back; B = 0 or no bytes give zeros without a launch. A
    CPU tensor runs ``crc32_blocks_ref``."""
    global CRC_LAUNCHES
    _rows(rows, "rows")
    dev = rows.device
    B, n1 = rows.shape
    n2 = 0
    if tail is not None:
        _rows(tail, "tail")
        if tail.shape[0] != B or tail.device != dev:
            raise ValueError(f"tail {tuple(tail.shape)} on {tail.device} "
                             f"does not pair with rows {tuple(rows.shape)} "
                             f"on {dev}")
        n2 = tail.shape[1]
    if n1 + n2 >= MAX_ROW:
        raise ValueError(f"a row of {n1 + n2} bytes: at most {MAX_ROW - 1}")
    if dev.type == "cpu":
        return crc32_blocks_ref(rows, tail)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from ..kernels.build import load

    lib = load()
    if B == 0 or n1 + n2 == 0:
        return torch.zeros(B, dtype=torch.int32, device=dev).view(
            torch.uint32)
    U = units(n1, n2)
    grid = min(B * U, _max_ctas(lib, dev))
    partial = torch.empty(B * U, dtype=torch.int32, device=dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    p2 = tail.data_ptr() if n2 else 0
    s2 = tail.stride(0) if n2 else 0
    with torch.cuda.device(dev):
        _launch(lib.ect_crc32, rows.data_ptr(), rows.stride(0), n1, p2, s2,
                n2, B, SEG, U, grid, THREADS, partial.data_ptr(),
                out.data_ptr(),
                torch._C._cuda_getCurrentRawStream(dev.index))
    CRC_LAUNCHES += 1
    return out.view(torch.uint32)

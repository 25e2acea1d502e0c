"""The port's C++ host codec (ctypes bindings).

Counterpart of ``entropy_coders_tpu/native``, with its own copy of the C++
source (``fse_native.cpp``, only the functions the port calls) built at
first use by ``native.build`` into ``build/entropy_coders_tpu_torch/``. The
functions here take and return what the JAX package's do, byte for byte:
the k-way reference-format ``compress``/``decompress`` (the FLAG_PACKED
lane-size table), histogram header I/O, ``normalize`` (the scalar rows of
``normalize.normalize_batch``), the batched tANS table builds and the
OpenMP lane repack of the per-lane container. Nothing falls back: when the
library cannot be built or loaded, the first call raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = [
    "build_decode_tables",
    "build_encode_tables",
    "compress",
    "decompress",
    "lane_merge_batch",
    "lane_split_batch",
    "load",
    "normalize",
    "read_header",
    "write_header",
]

_P, _SZ, _I32, _I64 = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int32,
                       ctypes.c_int64)
_SIGNATURES = {
    "ect_compress": (ctypes.c_int, [ctypes.c_char_p, _SZ, ctypes.c_int,
                                    ctypes.c_int, _P, _SZ,
                                    ctypes.POINTER(_SZ)]),
    "ect_decompress": (ctypes.c_int, [ctypes.c_char_p, _SZ, ctypes.c_int, _P,
                                      _SZ, ctypes.POINTER(_SZ)]),
    "ect_read_header": (_SZ, [ctypes.c_char_p, _SZ, _P,
                              ctypes.POINTER(_I32), ctypes.POINTER(_I32)]),
    "ect_write_header": (_SZ, [_P, _I32, _I32, _P, _SZ]),
    "ect_normalize": (ctypes.c_int, [_P, ctypes.c_uint64, _I32, _P]),
    "ect_build_encode_tables": (ctypes.c_int, [_P, _I32, _I32, _P, _P, _P]),
    "ect_build_decode_tables": (ctypes.c_int, [_P, _I32, _I32, _P]),
    "ect_lane_merge_batch": (ctypes.c_int, [_P, _I64, _I32, _I32, _P, _P, _P,
                                            _I32]),
    "ect_lane_split_batch": (ctypes.c_int, [ctypes.POINTER(ctypes.c_char_p),
                                            _P, _I64, _P, _I32, _I32, _P,
                                            _I32]),
}

_lib = None


def load() -> ctypes.CDLL:
    """The host library, built at first use and loaded once."""
    global _lib
    if _lib is None:
        from .build import build

        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def compress(data, k: int = 1, table_log: int | None = None) -> bytes:
    """Reference-format compress (header + k-way payload).
    ``table_log=None`` picks the reference's ``optimal_log2``."""
    data = bytes(data)
    cap = 1024 + len(data) + (len(data) >> 6)
    out = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t()
    rc = load().ect_compress(data, len(data), k,
                             -1 if table_log is None else table_log, out, cap,
                             ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"native compress failed (rc={rc})")
    return out.raw[: out_len.value]


def decompress(frame, k: int = 1, max_out: int | None = None) -> bytes:
    """Reference-format decompress; ``max_out`` caps the output buffer."""
    frame = bytes(frame)
    cap = max_out if max_out is not None else max(len(frame) * 64, 1 << 20)
    out = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t()
    rc = load().ect_decompress(frame, len(frame), k, out, cap,
                               ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"native decompress failed (rc={rc})")
    return out.raw[: out_len.value]


def read_header(data) -> tuple[np.ndarray, int, int, int]:
    """Parse a histogram header: (table, log2, table_len, header_bytes)."""
    data = bytes(data)
    table = np.zeros(256, np.int32)
    log2, tl = ctypes.c_int32(), ctypes.c_int32()
    n = load().ect_read_header(data, len(data), _ptr(table), ctypes.byref(log2),
                               ctypes.byref(tl))
    if n == 0:
        raise ValueError("bad histogram header")
    return table, int(log2.value), int(tl.value), int(n)


def write_header(table, log2: int, table_len: int) -> bytes:
    """Histogram header bytes of a normalized table."""
    table = np.ascontiguousarray(table, np.int32)
    cap = 1024
    out = ctypes.create_string_buffer(cap)
    n = load().ect_write_header(_ptr(table), log2, table_len, out, cap)
    if n == 0:
        raise ValueError("header write failed")
    return out.raw[:n]


def normalize(counts, size: int, log2: int = -1) -> tuple[np.ndarray, int]:
    """Exact reference normalization of 256 counts (u64, so aggregated
    counts past 2^32 stay exact); ``log2=-1`` means ``optimal_log2``.
    Returns (table (256,) int32, effective log2); ValueError on a
    distribution the reference cannot normalize."""
    counts = np.ascontiguousarray(counts, np.uint64)
    table = np.zeros(256, np.int32)
    l2 = load().ect_normalize(_ptr(counts), size, log2, _ptr(table))
    if l2 < 0:
        raise ValueError("normalization failed (degenerate input)")
    return table, int(l2)


def _norm_tables(norm_tables: np.ndarray) -> tuple[np.ndarray, int]:
    nt = np.ascontiguousarray(norm_tables, np.int32)
    if nt.ndim != 2 or nt.shape[1] != 256:
        raise ValueError(f"norm_tables must be (B, 256), got {nt.shape}")
    return nt, nt.shape[0]


def build_encode_tables(norm_tables: np.ndarray, log2: int):
    """Batched encode-table build from (B, 256) normalized histograms
    sharing ``log2``: ``(table (B, 2^log2) u16, tt_bits (B, 256) u32,
    tt_fs (B, 256) i32)``, bit-identical to ``spec.fse.EncodeTable``."""
    nt, B = _norm_tables(norm_tables)
    table = np.zeros((B, 1 << log2), np.uint16)
    tt_bits = np.zeros((B, 256), np.uint32)
    tt_fs = np.zeros((B, 256), np.int32)
    rc = load().ect_build_encode_tables(_ptr(nt), B, log2, _ptr(table),
                                        _ptr(tt_bits), _ptr(tt_fs))
    if rc != 0:
        raise ValueError(f"encode table build failed (rc={rc})")
    return table, tt_bits, tt_fs


def build_decode_tables(norm_tables: np.ndarray, log2: int) -> np.ndarray:
    """Batched decode-table build: (B, 256) normalized histograms ->
    (B, 2^log2) u32 entries (sym<<24 | nb<<16 | base), identical to
    ``spec.fse.DecodeTable.packed``."""
    nt, B = _norm_tables(norm_tables)
    packed = np.zeros((B, 1 << log2), np.uint32)
    rc = load().ect_build_decode_tables(_ptr(nt), B, log2, _ptr(packed))
    if rc != 0:
        raise ValueError(f"decode table build failed (rc={rc})")
    return packed


def lane_merge_batch(words: np.ndarray, sizes_bits: np.ndarray,
                     pack_bits: bool = False) -> list[bytes]:
    """Lane merge of a block group: ``words (B, W, k)`` u32, ``sizes_bits
    (B, k)`` -> one wire payload per block (byte-aligned lanes, or
    bit-packed with ``pack_bits``), in one OpenMP-parallel call."""
    words = np.ascontiguousarray(words, np.uint32)
    B, W, k = words.shape
    sizes = np.ascontiguousarray(sizes_bits, np.int32).reshape(B, k)
    if pack_bits:
        totals = (sizes.astype(np.int64).sum(axis=1) + 7) // 8
        caps = totals + 8  # the bit packer's slack per block
    else:
        totals = ((sizes.astype(np.int64) + 7) // 8).sum(axis=1)
        caps = totals
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    out = np.zeros(int(offs[-1]), np.uint8)
    rc = load().ect_lane_merge_batch(_ptr(words), B, W, k, _ptr(sizes),
                                     _ptr(offs), _ptr(out), int(pack_bits))
    if rc != 0:
        raise ValueError(f"lane merge failed for block {-rc - 1}")
    return [out[int(offs[b]): int(offs[b] + totals[b])].tobytes()
            for b in range(B)]


def lane_split_batch(payloads, sizes_bits: np.ndarray, k: int, W: int,
                     pack_bits: bool = False) -> np.ndarray:
    """Inverse of ``lane_merge_batch``: the group's ``(B, W, k)`` u32
    kernel layout from its wire payloads, in one OpenMP-parallel call."""
    B = len(payloads)
    sizes = np.ascontiguousarray(sizes_bits, np.int32).reshape(B, k)
    if pack_bits:  # the bit extractor reads 8 bytes past each payload
        payloads = [bytes(p) + b"\0" * 8 for p in payloads]
        plens = np.array([len(p) - 8 for p in payloads], np.int64)
    else:
        payloads = [bytes(p) for p in payloads]
        plens = np.array([len(p) for p in payloads], np.int64)
    ptrs = (ctypes.c_char_p * B)(*payloads)
    out = np.zeros((B, W, k), np.uint32)
    rc = load().ect_lane_split_batch(ptrs, _ptr(plens), B, _ptr(sizes), k, W,
                                     _ptr(out), int(pack_bits))
    if rc != 0:
        raise ValueError(f"lane payload too short (block {-rc - 1})")
    return out

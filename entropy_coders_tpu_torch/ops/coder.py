"""Shared-stream k-way interleaved tANS cores (counterpart of
``entropy_coders_tpu/ops/coder.py``).

The JAX package runs these as XLA ``lax.scan``s vmapped over blocks
(``_encode_core``/``_decode_core``, ``frame.py:55-67``). Here
``encode_core``/``decode_core`` are the wrappers of the hand-written kernels
D4 and D5 (``csrc/fse_coder.cu``, ``ect_fse_encode``/``ect_fse_decode``):
CUDA tensors launch the kernel (and raise if it cannot build or launch),
CPU tensors run the plain versions ``encode_core_ref``/``decode_core_ref``,
a Python loop over rounds vectorised over (blocks, lanes), int64
inside. ``ENCODE_LAUNCHES``/``DECODE_LAUNCHES`` count the launches. The
container takes these cores for every MODE_FSE block (``lanes=False``, a
group the per-lane path refuses, a ragged tail that is not lane-divisible),
and ``encode_interleaved``/``decode_interleaved`` wrap them for one
reference-format payload (the bytes ``spec.codec`` writes after the
histogram header).

``checked=True`` (``utils.checked``) checks every table index and bit
offset a core is about to use and raises ValueError on one out of range,
where the unchecked cores clamp it (the plain decode leaves torch to raise
on a table index). The kernels record, per block, the first check of the
plain versions' order that failed (``_check_error``), and the wrapper
raises the plain version's message.

k interleaved streams share one bitstream (the reference's own k=2 scheme,
generalized): because every lane's state is known at every round, per-lane
bit counts are known and an exclusive prefix sum gives every lane's bit
offset (reference per-symbol semantics: src/fse.rs:227-239, 363-373).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.launch import check as _check, launch as _launch
from .unsigned import (as_int64, int64_to_u32, resolve_device, to_device,
                       to_numpy)

__all__ = ["DECODE_LAUNCHES", "ENCODE_LAUNCHES", "blocks_to_syms",
           "decode_core", "decode_core_ref", "decode_interleaved",
           "encode_core", "encode_core_ref", "encode_interleaved",
           "encode_layout"]

ENCODE_LAUNCHES = 0  # D4 launches since import (or since a caller reset it)
DECODE_LAUNCHES = 0  # D5 launches


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_index(idx: torch.Tensor, n: int, what: str, used=None) -> None:
    """The sanitizer's check: every index in ``idx`` that is used (all, or
    where ``used``) lies in [0, n); else ValueError."""
    bad = (idx < 0) | (idx >= n)
    if used is not None:
        bad = bad & used
    if bool(bad.any()):
        raise ValueError(f"{what} out of range [0, {n})")


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1) - x


def _extract_bits(words: torch.Tensor, start: torch.Tensor, width,
                  checked: bool = False, used=None) -> torch.Tensor:
    """``width`` (<= 16) bits from bit ``start`` of each block's
    little-endian u32 word array ``words`` (B, Wd) int64 (>= 2 guard words
    of zero at the end); ``start`` is (B, k). Out-of-range word indices
    clamp, as JAX gathers do; ``checked`` raises on one that is ``used``."""
    Wd = words.shape[1]
    if checked:
        _check_index(start, 32 * (Wd - 1), "bit offset", used)
    start = start.clamp(min=0)
    w = (start >> 5).clamp(max=Wd - 1)
    b = start & 31
    lo = torch.gather(words, 1, w) >> b
    # only the next word's low 16 bits can reach a width <= 16 read
    hi = (torch.gather(words, 1, (w + 1).clamp(max=Wd - 1)) & 0xFFFF) << (32 - b)
    return (lo | hi) & ((torch.ones_like(start) << width) - 1)


# --- the emission layout of a block ---------------------------------------------


def encode_layout(n: int, k: int):
    """Static emission layout for blocks of raw length n: (m, R, valid (R, k)
    bool, finish_slots (k,) int64, W word rows)."""
    m = n - k
    R = max(_cdiv(m, k), 1)
    valid = (np.arange(R * k) < m).reshape(R, k)
    finish_slots = np.array([(n - 1 - s) % k for s in range(k - 1, -1, -1)],
                            np.int64)
    W = _cdiv((R * k + k) * 16 + 32, 32) + 2
    return m, R, valid, finish_slots, W


def blocks_to_syms(blocks: np.ndarray, m: int, R: int, k: int):
    """(B, n) raw blocks -> (B, R, k) symbols in emission order + (B, k)
    init symbols (slot t holds byte n-1-t)."""
    B, n = blocks.shape
    rev = blocks[:, :m][:, ::-1]
    pad = R * k - m
    if pad:
        rev = np.concatenate([rev, np.zeros((B, pad), np.uint8)], axis=1)
    syms = rev.reshape(B, R, k)
    init_syms = blocks[:, n - k:][:, ::-1].copy()
    return syms, init_syms


# --- the cores ----------------------------------------------------------------------


def encode_core_ref(syms, valid, init_syms, finish_slots, tables, *, k: int,
                    L: int, W: int, checked: bool = False):
    """Plain PyTorch version of D4: batched shared-stream encode
    (``_encode_core`` vmapped over blocks).

    syms: (B, R, k) uint8 symbols in emission order (descending index).
    valid: (R, k) bool emission mask.
    init_syms: (B, k) uint8 — slot t holds byte n-1-t (its lane's first
      symbol).
    finish_slots: (k,) int64 slot order of the final-state writes.
    tables: (table (B, 2^L) uint16, tt_bits (B, 256) uint32, tt_fs (B, 256)
      int32) on the same device.
    Returns (words (B, W) uint32, total_bits (B,) int64).
    """
    table, tt_bits, tt_fs = tables
    tab = as_int64(table)
    tb_t = as_int64(tt_bits)
    fs_t = tt_fs.to(torch.int64)
    size = tab.shape[1]
    B, R, _ = syms.shape

    # new_first_symbol for every lane, floor+1 form (reference
    # src/fse.rs:210-218; identical through table_log 14, defined at 15)
    init = init_syms.to(torch.int64)
    b0 = torch.gather(tb_t, 1, init)
    bits_out0 = (b0 >> 16) + 1
    value0 = (bits_out0 << 16) - b0
    idx0 = (value0 >> bits_out0) + torch.gather(fs_t, 1, init)
    if checked:
        _check_index(idx0, size, "initial next-state index")
    states = torch.gather(tab, 1, idx0.clamp(0, size - 1))

    vals, bits = [], []
    for r in range(R):
        s = syms[:, r].to(torch.int64)
        v = valid[r]
        bits_out = (torch.gather(tb_t, 1, s) + states) >> 16
        bits.append(torch.where(v, bits_out, 0))
        # padding slots contribute zero value too, not just zero width
        vals.append(torch.where(
            v, states & ((torch.ones_like(bits_out) << bits_out) - 1), 0))
        idx = (states >> bits_out) + torch.gather(fs_t, 1, s)
        if checked:  # padding slots' indices are discarded, not used
            _check_index(idx, size, "next-state index", v)
        new = torch.gather(tab, 1, idx.clamp(0, size - 1))
        states = torch.where(v, new, states)

    # stream close: final states of lanes k-1..0, then the marker bit
    # (reference: src/lib.rs:178-182)
    fin_vals = states[:, finish_slots] & ((1 << L) - 1)
    one = torch.ones((B, 1), dtype=torch.int64, device=syms.device)
    all_vals = torch.cat([torch.stack(vals, 1).reshape(B, -1), fin_vals, one], 1)
    all_bits = torch.cat([torch.stack(bits, 1).reshape(B, -1),
                          torch.full_like(fin_vals, L), one], 1)
    offs = _exclusive_cumsum(all_bits)
    total_bits = offs[:, -1] + all_bits[:, -1]
    w = offs >> 5
    b = offs & 31
    if checked:
        _check_index(w + 1, W, "bit offset's word")
    words = torch.zeros((B, W + 1), dtype=torch.int64, device=syms.device)
    # bit ranges are disjoint, so add is exact; row W catches the spill of
    # the last word (dropped, as JAX drops out-of-range scatter rows)
    words.scatter_add_(1, w.clamp(max=W), (all_vals << b) & 0xFFFFFFFF)
    words.scatter_add_(1, (w + 1).clamp(max=W), all_vals >> (32 - b))
    return int64_to_u32(words[:, :W]), total_bits


def decode_core_ref(words, total_bits, packed, *, k: int, L: int, R: int,
                    checked: bool = False):
    """Plain PyTorch version of D5: batched shared-stream decode
    (``_decode_core`` vmapped over blocks).

    words: (B, Wd) u32 payload words (uint32, or int64 holding u32 values)
      with >= 2 zero guard words.
    total_bits: (B,) int64 bit position of each block's marker bit.
    packed: (B, 2^L) uint32 decode entries (sym << 24 | nb << 16 | base).
    Returns (syms (B, R, k) uint8, emit_count (B,), finals (B, k) uint8,
    done (B,) bool, cursor (B,)); a block whose ``done`` is false or whose
    ``emit_count`` is not its length is corrupt.
    """
    pk_t = as_int64(packed)
    words = as_int64(words)
    B = words.shape[0]
    dev = words.device
    lanes = torch.arange(k, device=dev)

    # decoder init, lane 0 first (reference: src/lib.rs:224-225 via
    # src/fse.rs:349-352): lane s reads L bits at [c - (s+1)L, c - sL)
    starts = total_bits.unsqueeze(1) - (lanes + 1) * L
    states = _extract_bits(words, starts, L, checked)
    c = total_bits - k * L
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    fail_lane = torch.full((B,), -1, dtype=torch.int64, device=dev)
    emit_count = torch.zeros(B, dtype=torch.int64, device=dev)
    syms = torch.empty((B, R, k), dtype=torch.uint8, device=dev)
    for r in range(R):
        if checked:
            _check_index(states, pk_t.shape[1], "decode table index")
        pk = torch.gather(pk_t, 1, states)
        syms[:, r] = (pk >> 24).to(torch.uint8)
        nb = (pk >> 16) & 0xFF
        base = pk & 0xFFFF
        nb_eff = torch.where(done.unsqueeze(1), 0, nb)
        ex = _exclusive_cumsum(nb_eff)
        alive = ~done.unsqueeze(1) & (ex + nb_eff <= c.unsqueeze(1))
        low = _extract_bits(words, c.unsqueeze(1) - ex - nb_eff, nb_eff,
                            checked, alive)
        states = torch.where(alive, base + low, states)
        c = c - torch.where(alive, nb_eff, 0).sum(1)
        any_fail = ~alive.all(1)
        first_fail = torch.argmin(alive.to(torch.int32), 1)
        fail_lane = torch.where(done | ~any_fail, fail_lane, first_fail)
        emit_count = emit_count + alive.sum(1)
        done = done | any_fail

    # pending final-state symbols flush cyclically from the failed lane
    # (reference: src/lib.rs:233-243)
    fin_lanes = (fail_lane.unsqueeze(1) + lanes) % k
    if checked:
        _check_index(states, pk_t.shape[1], "decode table index")
    finals = (torch.gather(pk_t, 1, torch.gather(states, 1, fin_lanes))
              >> 24).to(torch.uint8)
    return syms, emit_count, finals, done, c


# --- the kernels' wrappers ----------------------------------------------------

# The kernels' per-block error word holds the smallest sequence number, in
# the order the plain versions run their checks, of a check that failed
# there: encode 1 the initial next-state indices, 2 + r round r's, R + 2 the
# last bit's word; decode 1 the initial bit offsets, 2 + 2r round r's table
# indices, 3 + 2r its bit offsets, 2 + 2R the final table indices.


def _encode_check(seq: int, R: int, size: int, W: int):
    if seq == 1:
        return "initial next-state index", size
    return ("next-state index", size) if seq <= R + 1 else \
        ("bit offset's word", W)


def _decode_check(seq: int, size: int, Wd: int):
    return ("decode table index", size) if seq % 2 == 0 else \
        ("bit offset", 32 * (Wd - 1))


def _check_error(err: torch.Tensor, name_of) -> None:
    """Raise the plain version's ValueError for the first failed check
    that any block's error word (-1: none) records."""
    failed = err[err >= 0]
    if failed.numel():
        what, n = name_of(int(failed.min()))
        raise ValueError(f"{what} out of range [0, {n})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _library():
    """The kernels' library (built at first use): loaded before anything
    is allocated on the card, so that a failed build raises first."""
    from ..kernels.build import load

    return load()


def encode_core(syms, valid, init_syms, finish_slots, tables, *, k: int,
                L: int, W: int, checked: bool = False):
    """Batched shared-stream encode (D4's wrapper; ``_encode_core`` vmapped
    over blocks).

    syms: (B, R, k) uint8 symbols in emission order (descending index).
    valid: (R, k) bool emission mask.
    init_syms: (B, k) uint8 — slot t holds byte n-1-t (its lane's first
      symbol).
    finish_slots: (k,) int64 slot order of the final-state writes, in
      [0, k).
    tables: (table (B, size) uint16, tt_bits (B, 256) uint32, tt_fs
      (B, 256) int32) on the same device; size is 2^L for built tables.
    Returns (words (B, W) uint32, total_bits (B,) int64).

    CUDA tensors launch D4 (and raise if it cannot build or launch); CPU
    tensors run ``encode_core_ref``."""
    global ENCODE_LAUNCHES
    dev = syms.device
    if dev.type == "cpu":
        return encode_core_ref(syms, valid, init_syms, finish_slots, tables,
                               k=k, L=L, W=W, checked=checked)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    table, tt_bits, tt_fs = tables
    if syms.dim() != 3 or table.dim() != 2:
        raise ValueError(f"syms must be (B, R, k) and table (B, size), got "
                         f"{tuple(syms.shape)}, {tuple(table.shape)}")
    B, R, _ = syms.shape
    size = table.shape[1]
    if not 1 <= L <= 16 or W < 1 or size < 1:
        raise ValueError(f"bad table log {L}, word count {W} or table size "
                         f"{size}")
    _check(syms, "syms", (B, R, k), torch.uint8, dev)
    _check(valid, "valid", (R, k), torch.bool, dev)
    _check(init_syms, "init_syms", (B, k), torch.uint8, dev)
    _check(finish_slots, "finish_slots", (k,), torch.int64, dev)
    _check(table, "table", (B, size), torch.uint16, dev)
    _check(tt_bits, "tt_bits", (B, 256), torch.uint32, dev)
    _check(tt_fs, "tt_fs", (B, 256), torch.int32, dev)
    lib = _library()
    words = torch.empty((B, W), dtype=torch.int32, device=dev)  # D4 fills
    total_bits = torch.empty(B, dtype=torch.int64, device=dev)
    if B:
        err = (torch.full((B,), -1, dtype=torch.int64, device=dev)
               if checked else None)
        with torch.cuda.device(dev):
            _launch(lib.ect_fse_encode, syms.data_ptr(), valid.data_ptr(),
                    init_syms.data_ptr(), finish_slots.data_ptr(),
                    table.data_ptr(), tt_bits.data_ptr(), tt_fs.data_ptr(),
                    words.data_ptr(), total_bits.data_ptr(),
                    None if err is None else err.data_ptr(),
                    B, R, k, L, size, W, _stream(dev))
        ENCODE_LAUNCHES += 1
        if checked:
            _check_error(err, lambda s: _encode_check(s, R, size, W))
    return words.view(torch.uint32), total_bits


def decode_core(words, total_bits, packed, *, k: int, L: int, R: int,
                checked: bool = False):
    """Batched shared-stream decode (D5's wrapper; ``_decode_core`` vmapped
    over blocks).

    words: (B, Wd) u32 payload words (uint32, or int64 holding u32 values)
      with >= 2 zero guard words.
    total_bits: (B,) int64 bit position of each block's marker bit.
    packed: (B, size) uint32 decode entries (sym << 24 | nb << 16 | base);
      size is 2^L for built tables.
    Returns (syms (B, R, k) uint8, emit_count (B,) int64, finals (B, k)
    uint8, done (B,) bool, cursor (B,) int64); a block whose ``done`` is
    false or whose ``emit_count`` is not its length is corrupt.

    CUDA tensors launch D5 (and raise if it cannot build or launch); CPU
    tensors run ``decode_core_ref``."""
    global DECODE_LAUNCHES
    dev = words.device
    if dev.type == "cpu":
        return decode_core_ref(words, total_bits, packed, k=k, L=L, R=R,
                               checked=checked)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if words.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"words must be (B, Wd) and packed (B, size), got "
                         f"{tuple(words.shape)}, {tuple(packed.shape)}")
    B, Wd = words.shape
    size = packed.shape[1]
    if not 1 <= L <= 16 or R < 0 or Wd < 1 or size < 1:
        raise ValueError(f"bad table log {L}, round count {R}, word count "
                         f"{Wd} or table size {size}")
    if words.dtype == torch.int64:
        words = int64_to_u32(words & 0xFFFFFFFF)
    _check(words, "words", (B, Wd), torch.uint32, dev)
    _check(total_bits, "total_bits", (B,), torch.int64, dev)
    _check(packed, "packed", (B, size), torch.uint32, dev)
    lib = _library()
    syms = torch.empty((B, R, k), dtype=torch.uint8, device=dev)
    emit_count = torch.empty(B, dtype=torch.int64, device=dev)
    finals = torch.empty((B, k), dtype=torch.uint8, device=dev)
    done = torch.empty(B, dtype=torch.bool, device=dev)
    cursor = torch.empty(B, dtype=torch.int64, device=dev)
    if B:
        err = (torch.full((B,), -1, dtype=torch.int64, device=dev)
               if checked else None)
        with torch.cuda.device(dev):
            _launch(lib.ect_fse_decode, words.data_ptr(),
                    total_bits.data_ptr(), packed.data_ptr(), syms.data_ptr(),
                    emit_count.data_ptr(), finals.data_ptr(), done.data_ptr(),
                    cursor.data_ptr(),
                    None if err is None else err.data_ptr(),
                    B, Wd, k, L, size, R, _stream(dev))
        DECODE_LAUNCHES += 1
        if checked:
            _check_error(err, lambda s: _decode_check(s, size, Wd))
    return syms, emit_count, finals, done, cursor


# --- one reference-format payload -------------------------------------------------


def encode_interleaved(data, k: int, enc_table, table_log: int, core=None,
                       *, device=None):
    """Encode ``data`` (uint8, len >= max(k, 2)) with ``k`` interleaved
    streams; ``enc_table`` is a ``spec.fse.EncodeTable``. Returns
    ``(payload_bytes, payload_bits)``, byte-identical to
    ``spec.codec.fse_compress``'s payload (header excluded) and to
    ``entropy_coders_tpu.ops.coder.encode_interleaved``. ``core``
    substitutes ``encode_core`` (``utils.checked``); ``device`` is where it
    runs (default ``"cuda"``, which raises when CUDA is unavailable)."""
    dev = resolve_device("cuda" if device is None else device)
    data = np.asarray(data, dtype=np.uint8)
    m, R, valid, finish_slots, W = encode_layout(len(data), k)
    syms, init_syms = blocks_to_syms(data[None], m, R, k)
    words, total_bits = (core or encode_core)(
        torch.from_numpy(np.ascontiguousarray(syms)).to(dev),
        torch.from_numpy(valid).to(dev), torch.from_numpy(init_syms).to(dev),
        torch.from_numpy(finish_slots).to(dev),
        tuple(to_device(t[None], dev) for t in (
            enc_table.table, enc_table.tt_bits, enc_table.tt_find_state)),
        k=k, L=int(table_log), W=W)
    total_bits = int(total_bits[0])
    nbytes = (total_bits + 7) // 8
    payload = to_numpy(words[0, : _cdiv(nbytes, 4)]).astype("<u4").tobytes()
    return payload[:nbytes], total_bits


def decode_interleaved(payload, k: int, dec_table, table_log: int,
                       max_out: int, core=None, *, device=None):
    """Decode one k-way interleaved payload (the reversed bit stack after
    the histogram header); ``dec_table`` is a ``spec.fse.DecodeTable``.
    Returns the decoded bytes, or ``None`` on a framing error (no marker
    bit, a marker more than 8 bits from the end, fewer than k * table_log
    bits), as ``entropy_coders_tpu.ops.coder.decode_interleaved`` does.
    ``max_out`` bounds the output (capacity, not exact): ValueError when
    the decode does not finish within it. ``core`` substitutes
    ``decode_core`` (``utils.checked``); ``device`` as in
    ``encode_interleaved``."""
    dev = resolve_device("cuda" if device is None else device)
    buf = np.frombuffer(payload, dtype=np.uint8)
    nz = np.flatnonzero(buf)
    if nz.size == 0:
        return None
    last = int(nz[-1])
    marker = last * 8 + int(buf[last]).bit_length() - 1
    if len(buf) * 8 - marker > 8:
        return None  # framing error (src/bitstream/stack_reader.rs:81-83)
    if marker < k * table_log:
        return None
    padded = np.zeros(_cdiv(len(buf), 4) * 4 + 8, np.uint8)
    padded[: len(buf)] = buf
    words = torch.from_numpy(padded.view("<u4").astype(np.int64)[None]).to(dev)
    syms, emit_count, finals, done, _ = (core or decode_core)(
        words, torch.tensor([marker], dtype=torch.int64, device=dev),
        to_device(np.asarray(dec_table.packed, np.uint32)[None], dev),
        k=k, L=int(table_log), R=max(_cdiv(max_out, k), 1) + 1)
    if not bool(done[0]):
        raise ValueError("decode capacity too small: increase max_out")
    flat = syms[0].reshape(-1)[: int(emit_count[0])]
    return torch.cat([flat, finals[0]]).cpu().numpy().tobytes()

"""Shared-stream k-way interleaved tANS cores (counterpart of
``entropy_coders_tpu/ops/coder.py``), plain PyTorch.

The JAX package runs these as XLA ``lax.scan``s vmapped over blocks, not as
Pallas kernels, so the port's counterpart is plain PyTorch with a Python loop
over rounds, vectorised over (blocks, lanes), int64 throughout. The
container needs them for blocks that the per-lane path cannot take, such as
a ragged tail that is not lane-divisible (``frame._encode_tail``).

k interleaved streams share one bitstream (the reference's own k=2 scheme,
generalized): because every lane's state is known at every round, per-lane
bit counts are known and an exclusive prefix sum gives every lane's bit
offset (reference per-symbol semantics: src/fse.rs:227-239, 363-373).
"""

from __future__ import annotations

import torch

from .unsigned import as_int64


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1) - x


def _extract_bits(words: torch.Tensor, start: torch.Tensor, width) -> torch.Tensor:
    """``width`` (<= 16) bits from bit ``start`` of each block's
    little-endian u32 word array ``words`` (B, Wd) int64 (>= 2 guard words
    of zero at the end); ``start`` is (B, k). Out-of-range word indices
    clamp, as JAX gathers do."""
    Wd = words.shape[1]
    start = start.clamp(min=0)
    w = (start >> 5).clamp(max=Wd - 1)
    b = start & 31
    lo = torch.gather(words, 1, w) >> b
    # only the next word's low 16 bits can reach a width <= 16 read
    hi = (torch.gather(words, 1, (w + 1).clamp(max=Wd - 1)) & 0xFFFF) << (32 - b)
    return (lo | hi) & ((torch.ones_like(start) << width) - 1)


def encode_core(syms, valid, init_syms, finish_slots, tables, *, k: int,
                L: int, W: int):
    """Batched shared-stream encode (``_encode_core`` vmapped over blocks).

    syms: (B, R, k) uint8 symbols in emission order (descending index).
    valid: (R, k) bool emission mask.
    init_syms: (B, k) uint8 — slot t holds byte n-1-t (its lane's first
      symbol).
    finish_slots: (k,) int64 slot order of the final-state writes.
    tables: (table (B, 2^L) uint16, tt_bits (B, 256) uint32, tt_fs (B, 256)
      int32) on the same device.
    Returns (words (B, W) int64 holding u32 values, total_bits (B,) int64).
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
    words = torch.zeros((B, W + 1), dtype=torch.int64, device=syms.device)
    # bit ranges are disjoint, so add is exact; row W catches the spill of
    # the last word (dropped, as JAX drops out-of-range scatter rows)
    words.scatter_add_(1, w.clamp(max=W), (all_vals << b) & 0xFFFFFFFF)
    words.scatter_add_(1, (w + 1).clamp(max=W), all_vals >> (32 - b))
    return words[:, :W], total_bits


def decode_core(words, total_bits, packed, *, k: int, L: int, R: int):
    """Batched shared-stream decode (``_decode_core`` vmapped over blocks).

    words: (B, Wd) int64 u32 payload words with >= 2 zero guard words.
    total_bits: (B,) int64 bit position of each block's marker bit.
    packed: (B, 2^L) uint32 decode entries (sym << 24 | nb << 16 | base).
    Returns (syms (B, R, k) uint8, emit_count (B,), finals (B, k) uint8,
    done (B,) bool, cursor (B,)); a block whose ``done`` is false or whose
    ``emit_count`` is not its length is corrupt.
    """
    pk_t = as_int64(packed)
    B = words.shape[0]
    dev = words.device
    lanes = torch.arange(k, device=dev)

    # decoder init, lane 0 first (reference: src/lib.rs:224-225 via
    # src/fse.rs:349-352): lane s reads L bits at [c - (s+1)L, c - sL)
    starts = total_bits.unsqueeze(1) - (lanes + 1) * L
    states = _extract_bits(words, starts, L)
    c = total_bits - k * L
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    fail_lane = torch.full((B,), -1, dtype=torch.int64, device=dev)
    emit_count = torch.zeros(B, dtype=torch.int64, device=dev)
    syms = torch.empty((B, R, k), dtype=torch.uint8, device=dev)
    for r in range(R):
        pk = torch.gather(pk_t, 1, states)
        syms[:, r] = (pk >> 24).to(torch.uint8)
        nb = (pk >> 16) & 0xFF
        base = pk & 0xFFFF
        nb_eff = torch.where(done.unsqueeze(1), 0, nb)
        ex = _exclusive_cumsum(nb_eff)
        alive = ~done.unsqueeze(1) & (ex + nb_eff <= c.unsqueeze(1))
        low = _extract_bits(words, c.unsqueeze(1) - ex - nb_eff, nb_eff)
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
    finals = (torch.gather(pk_t, 1, torch.gather(states, 1, fin_lanes))
              >> 24).to(torch.uint8)
    return syms, emit_count, finals, done, c

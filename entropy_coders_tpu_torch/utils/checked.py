"""Bounds-checked sanitizer mode for the shared-stream cores (counterpart of
``entropy_coders_tpu/utils/checked.py``).

The JAX package runs its XLA cores under ``jax.experimental.checkify``, so
an out-of-bounds table gather or bit read surfaces as an error instead of
XLA's silent clamping (the reference's debug-build asserts:
src/bitstream/writer.rs:142-145, 165-175). Here the same cores
(``ops.coder.encode_core``/``decode_core``) run with ``checked=True``: every
table index and bit offset is checked before it is used, and one out of
range raises ``ValueError`` where the unchecked cores clamp it or torch
raises its own ``IndexError``/``RuntimeError``. On the CPU the plain
versions check as they go; on CUDA the kernels D4/D5 record, per block, the
first check that failed in the plain versions' order, and the wrapper
raises the same message after the launch. A sanitizer: slower, for tests
and debugging. The per-lane kernels have their counterpart in the
plain versions and the cursor-drain check (``ops.pl_coder``).

``checked_encode_core``/``checked_decode_core`` take the JAX package's
arguments: one stream, numpy arrays or tensors (``ops.unsigned``'s entry
rule: ``device=None`` is the tensors' device, ``"cuda"`` for numpy). The
interleaved codecs call the batched cores of ``ops.coder`` directly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import coder
from ..ops.unsigned import as_int64, entry_device, entry_tensor

__all__ = [
    "checked_decode_core", "checked_decode_interleaved",
    "checked_encode_core", "checked_encode_interleaved",
]


def checked_encode_core(syms, valid, init_syms, finish_slots, tt_bits, tt_fs,
                        table, *, k, L, W, device=None):
    """``ops.coder.encode_core`` on one stream with every index checked,
    as the JAX package's ``checked_encode_core`` takes it: syms (R, k)
    uint8 in emission order, valid (R, k) bool, init_syms (k,) uint8,
    finish_slots (k,) int, tt_bits (256,) uint32, tt_fs (256,) int32,
    table (2^L,) uint16. Returns (words (W,) uint32, total_bits () int64),
    the JAX core's values."""
    dev = entry_device(device, syms, valid, init_syms, finish_slots, tt_bits,
                       tt_fs, table)
    words, total_bits = coder.encode_core(
        entry_tensor(syms, np.uint8, dev)[None],
        entry_tensor(valid, np.bool_, dev).bool(),
        entry_tensor(init_syms, np.uint8, dev)[None],
        entry_tensor(finish_slots, np.int64, dev).long(),
        tuple(entry_tensor(t, dt, dev)[None] for t, dt in (
            (table, np.uint16), (tt_bits, np.uint32), (tt_fs, np.int32))),
        k=k, L=L, W=W, checked=True)
    return words[0], total_bits[0]


def checked_decode_core(words, total_bits, packed, *, k, L, R, device=None):
    """``ops.coder.decode_core`` on one stream with every index checked,
    as the JAX package's ``checked_decode_core`` takes it: words (Wd,)
    u32 with >= 2 zero guard words, total_bits a scalar (the marker bit's
    position), packed (2^L,) uint32 decode entries. Returns (syms (R, k)
    uint8, emit_count, finals (k,) uint8, done, cursor), the JAX core's
    values."""
    dev = entry_device(device, words, total_bits, packed)
    syms, emit_count, finals, done, c = coder.decode_core(
        as_int64(entry_tensor(words, np.uint32, dev))[None],
        entry_tensor(total_bits, np.int64, dev).to(torch.int64).reshape(1),
        entry_tensor(packed, np.uint32, dev)[None],
        k=k, L=L, R=R, checked=True)
    return syms[0], emit_count[0], finals[0], done[0], c[0]


def checked_encode_interleaved(data, k, enc_table, table_log, *, device=None):
    """``ops.coder.encode_interleaved`` with the checked core."""
    return coder.encode_interleaved(
        data, k, enc_table, table_log,
        core=functools.partial(coder.encode_core, checked=True),
        device=device)


def checked_decode_interleaved(payload, k, dec_table, table_log, max_out, *,
                               device=None):
    """``ops.coder.decode_interleaved`` with the checked core."""
    return coder.decode_interleaved(
        payload, k, dec_table, table_log, max_out,
        core=functools.partial(coder.decode_core, checked=True),
        device=device)

"""Bounds-checked sanitizer mode for the shared-stream cores (counterpart of
``entropy_coders_tpu/utils/checked.py``).

The JAX package runs its XLA cores under ``jax.experimental.checkify``, so
an out-of-bounds table gather or bit read surfaces as an error instead of
XLA's silent clamping (the reference's debug-build asserts:
src/bitstream/writer.rs:142-145, 165-175). Here the same cores
(``ops.coder.encode_core``/``decode_core``) run with ``checked=True``: every
table index and bit offset is checked before it is used, and one out of
range raises ``ValueError`` where the unchecked cores clamp it or torch
raises its own ``IndexError``/``RuntimeError``. A sanitizer: slower, for
tests and debugging. The per-lane kernels have their counterpart in the
plain versions and the cursor-drain check (``ops.pl_coder``).
"""

from __future__ import annotations

from ..ops import coder

__all__ = [
    "checked_decode_core", "checked_decode_interleaved",
    "checked_encode_core", "checked_encode_interleaved",
]


def checked_encode_core(syms, valid, init_syms, finish_slots, tables, *, k,
                        L, W):
    """``ops.coder.encode_core`` with every index checked."""
    return coder.encode_core(syms, valid, init_syms, finish_slots, tables,
                             k=k, L=L, W=W, checked=True)


def checked_decode_core(words, total_bits, packed, *, k, L, R):
    """``ops.coder.decode_core`` with every index checked."""
    return coder.decode_core(words, total_bits, packed, k=k, L=L, R=R,
                             checked=True)


def checked_encode_interleaved(data, k, enc_table, table_log, *, device=None):
    """``ops.coder.encode_interleaved`` with the checked core."""
    return coder.encode_interleaved(data, k, enc_table, table_log,
                                    core=checked_encode_core, device=device)


def checked_decode_interleaved(payload, k, dec_table, table_log, max_out, *,
                               device=None):
    """``ops.coder.decode_interleaved`` with the checked core."""
    return coder.decode_interleaved(payload, k, dec_table, table_log,
                                    max_out, core=checked_decode_core,
                                    device=device)

"""Constants of the codec and its two host helpers (a copy of
``entropy_coders_tpu/constants.py``).

FSE table sizes are ``2**log2`` with ``log2`` in ``[TABLE_LOG_MIN,
TABLE_LOG_MAX]``; ``TABLE_LOG_DEFAULT`` is the reference's default
(reference: src/lib.rs:9-12).
"""

TABLE_LOG_MIN = 5
TABLE_LOG_MAX = 15
TABLE_LOG_DEFAULT = 11

# Number of distinct byte symbols; histograms and tables are this wide.
ALPHABET = 256


def mask(bits: int) -> int:
    """All-ones mask of width ``bits`` (reference: src/lib.rs:15-57)."""
    return (1 << bits) - 1


def ilog2(x: int) -> int:
    """Floor of log2 for a positive integer (Rust ``u32::ilog2``); raises
    ``ValueError`` for ``x <= 0``, where the reference's panics."""
    if x <= 0:
        raise ValueError(f"ilog2 of non-positive value {x}")
    return x.bit_length() - 1

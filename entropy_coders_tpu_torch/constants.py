"""Constants of the codec (a copy of ``entropy_coders_tpu/constants.py``,
the values the port uses).

FSE table sizes are ``2**log2`` with ``log2`` in ``[TABLE_LOG_MIN,
TABLE_LOG_MAX]``; ``TABLE_LOG_DEFAULT`` is the reference's default
(reference: src/lib.rs:9-12).
"""

TABLE_LOG_MIN = 5
TABLE_LOG_MAX = 15
TABLE_LOG_DEFAULT = 11

# Number of distinct byte symbols; histograms and tables are this wide.
ALPHABET = 256

"""size_table_ms.compress: the host's own time in the port's
ect.compress.size_table ranges (each per-lane block's lane-size table,
k=2-coded), per call (ms)."""

from ect_bench.stage_readers import stage_ms


def read(trace, run):
    return stage_ms(trace, run, "compress", "size_table")

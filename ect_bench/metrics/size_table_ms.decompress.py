"""size_table_ms.decompress: the host's own time in the port's
ect.decompress.size_table ranges (each per-lane block's lane-size table,
decoded), per call (ms)."""

from ect_bench.stage_readers import stage_ms


def read(trace, run):
    return stage_ms(trace, run, "decompress", "size_table")

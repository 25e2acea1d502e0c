"""crc_ms.compress: the host's own time in the port's ect.compress.crc range
(the crc32 pass over the call's blocks), per call (ms)."""

from ect_bench.stage_readers import stage_ms


def read(trace, run):
    return stage_ms(trace, run, "compress", "crc")

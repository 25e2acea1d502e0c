"""crc_ms.decompress: the host's own time in the port's ect.decompress.crc
range (the crc32 check of the decoded blocks), per call (ms)."""

from ect_bench.stage_readers import stage_ms


def read(trace, run):
    return stage_ms(trace, run, "decompress", "crc")

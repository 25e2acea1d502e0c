"""host_ms.compress: the host's own time in the ect.compress.* stages, per call (ms)."""

from ect_bench.readers import host_ms


def read(trace, run):
    return host_ms(trace, run, "compress")

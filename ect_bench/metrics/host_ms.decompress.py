"""host_ms.decompress: the host's own time in the ect.decompress.* stages, per call (ms)."""

from ect_bench.readers import host_ms


def read(trace, run):
    return host_ms(trace, run, "decompress")

"""host_ms.read: the host's own time in the ect.decompress.* stages, per
range read (ms)."""

from ect_bench.readers import host_ms


def read(trace, run):
    return host_ms(trace, run, "read")

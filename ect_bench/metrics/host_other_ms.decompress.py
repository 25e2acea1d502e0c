"""host_other_ms.decompress: the port's host time in its ect.decompress range outside every
stage, per call (ms)."""

from ect_bench.call_readers import host_other_ms


def read(trace, run):
    return host_other_ms(trace, run, "decompress")

"""host_other_ms.compress: the port's host time in its ect.compress range outside every
stage, per call (ms)."""

from ect_bench.call_readers import host_other_ms


def read(trace, run):
    return host_other_ms(trace, run, "compress")

"""copy_ms.decompress: device time of host-device copies, per decompress call (ms)."""

from ect_bench.readers import copy_ms


def read(trace, run):
    return copy_ms(trace, run, "decompress")

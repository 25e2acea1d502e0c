"""copy_ms.compress: device time of host-device copies, per compress call (ms)."""

from ect_bench.readers import copy_ms


def read(trace, run):
    return copy_ms(trace, run, "compress")

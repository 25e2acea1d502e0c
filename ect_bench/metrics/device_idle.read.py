"""device_idle.read: share of the range reads' wall time with nothing on
the card (%)."""

from ect_bench.readers import device_idle


def read(trace, run):
    return device_idle(trace, run, "read")

"""device_idle.compress: share of the compress calls' wall time with nothing on a
card (%, the mean over the cards)."""

from ect_bench.readers import device_idle


def read(trace, run):
    return device_idle(trace, run, "compress")

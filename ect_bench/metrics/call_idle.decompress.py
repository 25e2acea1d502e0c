"""call_idle.decompress: share of the wall time of the port's ect.decompress ranges with
nothing on a card (%, the mean over the cards)."""

from ect_bench.call_readers import call_idle


def read(trace, run):
    return call_idle(trace, run, "decompress")

"""mesh_overlap.compress: the union of the cards' busy intervals in the compress
calls over their sum (%)."""

from ect_bench.readers import mesh_overlap


def read(trace, run):
    return mesh_overlap(trace, run, "compress")

"""mesh_overlap.decompress: the union of the cards' busy intervals in the decompress
calls over their sum (%)."""

from ect_bench.readers import mesh_overlap


def read(trace, run):
    return mesh_overlap(trace, run, "decompress")

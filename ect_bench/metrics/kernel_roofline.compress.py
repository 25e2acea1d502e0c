"""kernel_roofline.compress: the compress calls' algorithm bytes at the card's peak
over their kernels' device time (%)."""

from ect_bench.readers import kernel_roofline


def read(trace, run):
    return kernel_roofline(trace, run, "compress")

"""host_alloc_MB.compress: the fresh host bytes a compress call of the port makes, by
its host_bytes.compress.* counters (MB a call)."""

from ect_bench.call_readers import host_alloc_mb


def read(trace, run):
    return host_alloc_mb(trace, run, "compress")

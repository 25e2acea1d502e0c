"""host_alloc_MB.decompress: the fresh host bytes a decompress call of the port makes, by
its host_bytes.decompress.* counters (MB a call)."""

from ect_bench.call_readers import host_alloc_mb


def read(trace, run):
    return host_alloc_mb(trace, run, "decompress")

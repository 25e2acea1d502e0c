"""mesh_dispatch_lag_ms.compress: over each round of share dispatches of a compress
call, the last share's dispatch end less the first's, summed (ms a call)."""

from ect_bench.call_readers import mesh_dispatch_lag_ms


def read(trace, run):
    return mesh_dispatch_lag_ms(trace, run, "compress")

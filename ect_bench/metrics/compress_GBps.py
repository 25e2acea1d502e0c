"""compress_GBps: raw bytes passed to frame.compress in the window over
the summed wall time of those calls (GB/s, 1e9 bytes)."""


def read(trace, run):
    c = run["calls"].get("compress")
    if not c or not c["n"] or c["seconds"] <= 0:
        return None
    return c["raw"] / c["seconds"] / 1e9

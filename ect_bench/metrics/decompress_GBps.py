"""decompress_GBps: raw bytes returned by whole-frame frame.decompress
calls in the window over the summed wall time of those calls (GB/s)."""


def read(trace, run):
    c = run["calls"].get("decompress")
    if not c or not c["n"] or c["seconds"] <= 0:
        return None
    return c["raw"] / c["seconds"] / 1e9

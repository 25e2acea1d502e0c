"""read_p95_ms: the 95th percentile of the wall time of every range read
in the window (ms; linear interpolation between order statistics)."""

import numpy as np


def read(trace, run):
    c = run["calls"].get("read")
    if not c or not c["n"]:
        return None
    return float(np.percentile(np.asarray(c["times"]) * 1e3, 95))

"""ratio: frame bytes over raw bytes, over every frame the window made."""


def read(trace, run):
    c = run["calls"].get("compress")
    if not c or not c["raw"]:
        return None
    return c["frame"] / c["raw"]

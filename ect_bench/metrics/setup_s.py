"""setup_s: from the process's start to the first timed call (s)."""


def read(trace, run):
    return run.get("setup_s") or None

"""Readers of single stages the program marks inside its calls: the
ranges ``ect.<op>.<stage>`` of one stage kind (the crc pass, ``crc``; each
block's lane-size table, ``size_table``). Each takes what the readers of
``readers.py`` take and returns a number, or None where the calls hold no
such range (a program without it, or frames without the flag the stage
serves)."""

from __future__ import annotations

from .tracing import inside


def stage_ms(trace, run: dict, op: str, stage: str) -> float | None:
    """Self time of the program's ``ect.<op>.<stage>`` ranges inside the
    calls of ``op``, per call, in ms: the host's own work in that stage,
    without the operators and ranges it holds."""
    calls = trace.calls(op)
    if not calls:
        return None
    name = f"ect.{op}.{stage}"
    own = [(trace.events[i].start, t) for i, t in trace.self_times().items()
           if trace.events[i].kind == "range"
           and trace.events[i].name == name]
    ok = inside([s for s, _ in own], [(c.start, c.end) for c in calls])
    got = [t for (_, t), k in zip(own, ok) if k]
    if not got:
        return None
    return sum(got) / len(calls) / 1e6

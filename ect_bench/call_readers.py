"""Readers of what the program marks of its own calls: the range
``ect.<op>`` around each public call of the port (``frame.compress``,
``frame.decompress``), the ranges ``ect.<op>.share_dispatch.<rank>`` of a
mesh share's dispatch, and the port's counters
(``entropy_coders_tpu_torch.utils.profiling.counters``). Each takes what
the readers of ``readers.py`` take and returns a number, or None where the
program marks nothing (a program without these ranges or counters)."""

from __future__ import annotations

import sys

from .tracing import busy, inside, length, union

COUNTERS_MODULE = "entropy_coders_tpu_torch.utils.profiling"


def port_calls(trace, op: str) -> list[int]:
    """Indices into ``trace.events`` of the program's ``ect.<op>`` ranges
    that start inside the harness's ``bench.<op>`` calls: the port's part
    of each call, without the harness's work around it."""
    calls = trace.calls(op)
    if not calls:
        return []
    name = f"ect.{op}"
    idx = [i for i, e in enumerate(trace.events)
           if e.kind == "range" and e.name == name]
    ok = inside([trace.events[i].start for i in idx],
                [(c.start, c.end) for c in calls])
    return [i for i, k in zip(idx, ok) if k]


def host_other_ms(trace, run: dict, op: str) -> float | None:
    """Self time of the ``ect.<op>`` ranges, per call, in ms: the host's
    time in the port's call outside every stage and operator."""
    idx = port_calls(trace, op)
    if not idx:
        return None
    own = trace.self_times()
    return sum(own[i] for i in idx) / len(idx) / 1e6


def call_idle(trace, run: dict, op: str) -> float | None:
    """Share of the ``ect.<op>`` ranges' wall time in which a card ran no
    kernel, copy or fill, in %, the mean over the cards: ``device_idle``
    over the port's calls alone."""
    idx = port_calls(trace, op)
    cards = run.get("cards") or trace.devices()
    if not idx or not cards:
        return None
    win = [(trace.events[i].start, trace.events[i].end) for i in idx]
    wall = length(union(win))
    if wall == 0:
        return None
    idle = [1 - length(busy(trace, c, win)) / wall for c in cards]
    return 100.0 * sum(idle) / len(idle)


def counters(run: dict) -> dict | None:
    """The port's counters: ``run["counters"]`` where the run passes them,
    else the loaded port's own, which hold every call the process has made
    (a cell's set-up makes calls of the window's size and knobs). None
    where the port keeps none."""
    if run.get("counters") is not None:
        return run["counters"]
    mod = sys.modules.get(COUNTERS_MODULE)
    return getattr(mod, "counters", None)


def host_alloc_mb(trace, run: dict, op: str) -> float | None:
    """The bytes of the fresh host buffers the port's calls of ``op``
    made (its ``host_bytes.<op>.*`` counters), per call, in MB (10^6)."""
    got = counters(run)
    if not got or not got.get(f"calls.{op}"):
        return None
    prefix = f"host_bytes.{op}."
    total = sum(v for k, v in got.items() if k.startswith(prefix))
    return total / got[f"calls.{op}"] / 1e6


def mesh_dispatch_lag_ms(trace, run: dict, op: str) -> float | None:
    """How long after the first share of a round of share dispatches the
    last one was queued, summed over the rounds of each call, per call, in
    ms: a round is a run of ``ect.<op>.share_dispatch.<rank>`` ranges in
    rising rank, and its lag the end of its last share's range less the
    end of its first's. 0 where every round has one share."""
    idx = port_calls(trace, op)
    if not idx:
        return None
    prefix = f"ect.{op}.share_dispatch."
    win = [(trace.events[i].start, trace.events[i].end) for i in idx]
    shares = [e for e in trace.events
              if e.kind == "range" and e.name.startswith(prefix)]
    shares = [e for e, k in zip(shares, inside([e.start for e in shares],
                                               win)) if k]
    if not shares:
        return None
    lag, first, last, rank = 0, None, None, -1
    for e in shares:
        r = int(e.name[len(prefix):])
        if r <= rank:  # a new round
            lag += last.end - first.end
            first = None
        if first is None:
            first = e
        last, rank = e, r
    lag += last.end - first.end
    return lag / len(idx) / 1e6

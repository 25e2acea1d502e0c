"""The traced run's events, as the per-layer readers take them.

``Trace`` holds every event of a ``torch.profiler`` window as plain arrays:
the host's ranges and operations (``kind`` "range" for a
``record_function`` range, "op" for an operator) with their thread, and the
device's kernels, copies and fills ("kernel", "memcpy", "memset") with
their card. Times are nanoseconds on the profiler's clock. The benchmark
wraps each timed call in a range named ``bench.<op>`` (``call_range``), so
a reader finds the calls of one kind and the events inside them.

``from_profiler`` builds a ``Trace`` from a finished profiler, through the
Chrome-format trace it exports (``from_chrome``); tests build one from
such a trace or from a list of event tuples.
"""

from __future__ import annotations

import json
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HOST_KINDS = ("range", "op")
DEVICE_KINDS = ("kernel", "memcpy", "memset")
_ACTIVITY = {"user_annotation": "range", "cpu_op": "op", "kernel": "kernel",
             "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


def call_range(op: str) -> str:
    """The name of the range around one timed call of ``op``."""
    return f"bench.{op}"


@dataclass
class Event:
    kind: str
    name: str
    start: int
    end: int
    where: int  # thread id for host events, card index for device events


class Trace:
    """Events of one traced window, ``t0``..``t1`` ns."""

    def __init__(self, events, t0: int | None = None, t1: int | None = None):
        self.events = sorted((Event(*e) if not isinstance(e, Event) else e
                              for e in events), key=lambda e: (e.start, -e.end))
        starts = [e.start for e in self.events] or [0]
        ends = [e.end for e in self.events] or [0]
        self.t0 = min(starts) if t0 is None else t0
        self.t1 = max(ends) if t1 is None else t1

    # --- calls --------------------------------------------------------------

    def calls(self, op: str) -> list[Event]:
        """The ``bench.<op>`` ranges, in order."""
        name = call_range(op)
        return [e for e in self.events if e.kind == "range" and e.name == name]

    def devices(self) -> list[int]:
        return sorted({e.where for e in self.events if e.kind in DEVICE_KINDS})

    def device_events(self, kinds=DEVICE_KINDS, card: int | None = None,
                      within=None) -> list[Event]:
        """Device events of ``kinds`` (on ``card``), those that start inside
        one of the intervals ``within`` when it is given."""
        evs = [e for e in self.events if e.kind in kinds
               and (card is None or e.where == card)]
        if within is None:
            return evs
        return [e for e, ok in zip(evs, inside([e.start for e in evs], within))
                if ok]

    # --- host self time -----------------------------------------------------

    def self_times(self) -> dict[int, int]:
        """Each host event's own time (index into ``events`` -> ns): its
        length less the time its direct children on its thread take."""
        out: dict[int, int] = {}
        stacks: dict[int, list[int]] = {}
        for i, e in enumerate(self.events):
            if e.kind not in HOST_KINDS:
                continue
            st = stacks.setdefault(e.where, [])
            while st and self.events[st[-1]].end <= e.start:
                st.pop()
            out[i] = e.end - e.start
            if st:
                out[st[-1]] -= e.end - e.start
            st.append(i)
        return out

    def innermost_ranges(self, times, prefix: str, floor: int) -> list:
        """For each time in ``times``, the innermost range whose name starts
        with ``prefix`` and that holds it, among those that start at or
        after ``floor`` (None where none does)."""
        rs = [e for e in self.events
              if e.kind == "range" and e.name.startswith(prefix)]
        starts = np.array([e.start for e in rs], np.int64)
        out = []
        for t in times:
            i = int(np.searchsorted(starts, t, side="right")) - 1
            name = None
            while i >= 0 and rs[i].start >= floor:
                if rs[i].end > t:  # the latest start that holds t
                    name = rs[i].name
                    break
                i -= 1
            out.append(name)
        return out


def inside(times, within) -> np.ndarray:
    """Which of ``times`` lie inside one of the intervals ``within``."""
    w = union(within)
    if not w:
        return np.zeros(len(times), bool)
    a = np.array([x for x, _ in w], np.int64)
    b = np.array([y for _, y in w], np.int64)
    t = np.asarray(times, np.int64)
    i = np.searchsorted(a, t, side="right") - 1
    return (i >= 0) & (t < b[np.maximum(i, 0)])


def intervals(evs) -> list[tuple[int, int]]:
    return [(e.start, e.end) for e in evs]


def union(iv) -> list[tuple[int, int]]:
    """Merged, sorted intervals."""
    out: list[list[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(iv) -> int:
    return sum(b - a for a, b in iv)


def clip(iv, within) -> list[tuple[int, int]]:
    """The parts of intervals ``iv`` that lie inside the intervals
    ``within``."""
    a, w = union(iv), union(within)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(w):
        lo, hi = max(a[i][0], w[j][0]), min(a[i][1], w[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < w[j][1]:
            i += 1
        else:
            j += 1
    return out


def busy(trace: Trace, card: int, within=None) -> list[tuple[int, int]]:
    """The merged intervals in which ``card`` ran a kernel, copy or fill
    (inside ``within`` where given)."""
    iv = union(intervals(trace.device_events(card=card)))
    return iv if within is None else clip(iv, within)


def gaps(busy_iv, within) -> list[tuple[int, int]]:
    """The parts of ``within`` that the merged, sorted ``busy_iv`` leave
    idle."""
    out, j = [], 0
    for a, b in union(within):
        while j < len(busy_iv) and busy_iv[j][1] <= a:
            j += 1
        t, i = a, j
        while i < len(busy_iv) and busy_iv[i][0] < b:
            c, d = busy_iv[i]
            if c > t:
                out.append((t, c))
            t = max(t, d)
            i += 1
        if t < b:
            out.append((t, b))
    return out


def from_chrome(trace: dict) -> Trace:
    """The events of a profiler trace in Chrome's format (the JSON
    ``export_chrome_trace`` writes): host ranges and operators, and the
    cards' kernels, copies and fills."""
    evs = []
    for e in trace.get("traceEvents", ()):
        kind = _ACTIVITY.get(e.get("cat"))
        if kind is None or e.get("ph") != "X":
            continue
        start = round(float(e["ts"]) * 1000)
        end = start + round(float(e.get("dur", 0)) * 1000)
        if kind in HOST_KINDS:
            where = e.get("tid", 0)
        else:
            where = e.get("args", {}).get("device", e.get("pid", 0))
        evs.append((kind, str(e["name"]), start, end, int(where)))
    return Trace(evs)


def from_profiler(prof) -> Trace:
    """The events of a finished ``torch.profiler.profile``, through its
    Chrome-format export in a temporary directory."""
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            return from_chrome(json.load(f))


def summary(trace: Trace, cards) -> dict:
    """``busy_s`` (the mean over ``cards`` of the time each ran anything),
    ``window_s`` and the breakdown: the ten device operations that took the
    most time, and the cards' idle time inside the timed calls by the
    ``ect.*`` range the host was in (``bench.<op>`` outside any), averaged
    over the cards."""
    window = [(trace.t0, trace.t1)]
    per = [length(busy(trace, c, window)) for c in cards]
    ops: dict[str, int] = {}
    for e in trace.device_events(within=window):
        ops[e.name] = ops.get(e.name, 0) + e.end - e.start
    idle: dict[str, float] = {}
    calls = [e for e in trace.events
             if e.kind == "range" and e.name.startswith("bench.")]
    for c in cards:
        b = busy(trace, c)
        for call in calls:
            g = gaps(b, [(call.start, call.end)])
            names = trace.innermost_ranges([(x + y) // 2 for x, y in g],
                                           "ect.", call.start)
            for (x, y), name in zip(g, names):
                key = name or call.name
                idle[key] = idle.get(key, 0) + (y - x) / len(cards)

    def top(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"busy_s": sum(per) / len(per) / 1e9 if per else 0.0,
            "window_s": (trace.t1 - trace.t0) / 1e9,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}

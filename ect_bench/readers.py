"""What the per-layer readers share: each metric's file under ``metrics/``
names its op and calls one of these. Every reader takes the traced run's
``tracing.Trace`` and ``run`` (the harness's record of the window: per op,
the calls made and their raw and frame bytes) and returns a number, or None
where the trace holds nothing to read."""

from __future__ import annotations

from . import roofline
from .tracing import busy, inside, length, union


def _windows(trace, op: str):
    calls = trace.calls(op)
    return calls, [(c.start, c.end) for c in calls]


def host_ms(trace, run: dict, op: str) -> float | None:
    """Self time of the program's ``ect.<stage>.*`` ranges inside the
    calls of ``op``, per call, in ms: the host's own work in the named
    stages, without the operators they call."""
    calls, win = _windows(trace, op)
    if not calls:
        return None
    prefix = "ect.compress." if op == "compress" else "ect.decompress."
    own = [(trace.events[i].start, t) for i, t in trace.self_times().items()
           if trace.events[i].kind == "range"
           and trace.events[i].name.startswith(prefix)]
    ok = inside([s for s, _ in own], win)
    return sum(t for (_, t), k in zip(own, ok) if k) / len(calls) / 1e6


def copy_ms(trace, run: dict, op: str) -> float | None:
    """Device time of the host-device copies that start inside the calls
    of ``op``, per call, in ms (summed over the cards)."""
    calls, win = _windows(trace, op)
    if not calls:
        return None
    evs = trace.device_events(kinds=("memcpy",), within=win)
    if not evs:
        return None
    return sum(e.end - e.start for e in evs) / len(calls) / 1e6


def kernel_roofline(trace, run: dict, op: str) -> float | None:
    """The algorithm's bytes of every call of ``op`` at the card's peak,
    over the device time of the kernels launched inside those calls, in %."""
    calls, win = _windows(trace, op)
    rec = run["calls"].get(op)
    if not calls or not rec or len(calls) != rec["n"]:
        return None
    kern = trace.device_events(kinds=("kernel",), within=win)
    t = sum(e.end - e.start for e in kern) / 1e9
    nbytes = roofline.call_bytes(op, rec["raw"], rec["frame"])
    return roofline.share_pct(nbytes, t, run.get("peak", roofline.PEAK_BYTES_PER_S))


def device_idle(trace, run: dict, op: str) -> float | None:
    """Share of the calls' wall time of ``op`` in which a card ran no
    kernel, copy or fill, in %, the mean over the cards."""
    calls, win = _windows(trace, op)
    cards = run.get("cards") or trace.devices()
    if not calls or not cards:
        return None
    wall = length(union(win))
    idle = [1 - length(busy(trace, c, win)) / wall for c in cards]
    return 100.0 * sum(idle) / len(idle)


def mesh_overlap(trace, run: dict, op: str) -> float | None:
    """The union of the cards' busy intervals inside the calls of ``op``
    over the sum of their lengths, in %: 100 where no two cards work at
    once, 100 / cards where all work at the same times. None on one card."""
    calls, win = _windows(trace, op)
    cards = run.get("cards") or trace.devices()
    if not calls or len(cards) < 2:
        return None
    per = [busy(trace, c, win) for c in cards]
    total = sum(length(p) for p in per)
    if total == 0:
        return None
    return 100.0 * length(union([iv for p in per for iv in p])) / total


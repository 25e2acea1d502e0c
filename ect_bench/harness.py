"""One run of one cell: set-up, the measured window, the check, the result.

``Runner`` drives the port's public frame API (``frame.compress`` and
``frame.decompress``; with a mesh, ``sharding=`` over the first ``chips``
cards) on host bytes made from the seed, as a closed loop with one caller
(``traffic``). It times every call on the host clock, keeps a sample of
the answers drawn from the seed, and once the window has closed holds them
against the plain reference (``reference``): each sampled frame block by
block, each sampled decompress or read byte by byte against the input that
call was given. A loop that compresses gives every call an input of its
own (``traffic.Relabel``), so no two calls of a run repeat the same work.

The run's numbers come from the metric files the benchmark names
(``registry.reader``): with ``trace`` the per-layer ones, read from a
``torch.profiler`` trace of the whole window; without it the end-to-end
ones, read from the harness's own record of the calls.
"""

from __future__ import annotations

import gc
import resource
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from . import data, registry, tracing
from .data import seed_words
from .reference import Knobs, check_frame
from .traffic import Reads, Relabel, Sample, check_spec

# top-level module names that must not be loaded in a run: JAX and the JAX
# package the port was made from (compared whole: the port's own name
# begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "entropy_coders_tpu")
_BLOCKS_TAG = 0xB10C


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(names)} & set(FORBIDDEN))


def knobs_of(cfg: dict) -> Knobs:
    """The reference's view of the configuration's knobs: ``block_size``,
    ``k`` and ``table_log`` stated, the others as ``frame.compress``
    defaults them on a card."""
    k = cfg["knobs"]
    return Knobs(int(k["block_size"]), int(k["k"]), k["table_log"],
                 bool(k.get("lanes", True)), bool(k.get("shared_table", False)),
                 bool(k.get("checksum", False)), bool(k.get("bit_pack", False)))


def port_kwargs(knobs: dict) -> dict:
    """The configuration's knobs as ``frame.compress`` takes them (a JSON
    list becomes the tuple a table-log policy is), ``lanes`` stated as
    the reference takes it, so that no default of the program decides."""
    out = {name: tuple(v) if isinstance(v, list) else v
           for name, v in knobs.items()}
    out["lanes"] = bool(knobs.get("lanes", True))
    return out


def check_blocks(n_blocks: int, block_size: int, total: int, chips: int,
                 want, seed: int):
    """The blocks a frame check covers: every block where ``want`` is None
    or not smaller than the frame; else ``want`` drawn from the seed, with
    the first, the last (the ragged tail) and the first and last of each
    mesh share of the full blocks."""
    if want is None or want >= n_blocks:
        return None
    full = total // block_size
    must = {0, n_blocks - 1}
    for i in range(chips):
        lo, hi = i * full // chips, (i + 1) * full // chips
        if hi > lo:
            must |= {lo, hi - 1}
    rng = np.random.default_rng(seed_words(seed) + [_BLOCKS_TAG])
    return sorted(must | set(rng.choice(n_blocks, int(want),
                                        replace=False).tolist()))


@dataclass
class Calls:
    """What the window did of one op."""
    n: int = 0
    raw: int = 0  # raw bytes in (compress) or out (decompress, read)
    frame: int = 0  # frame bytes out (compress) or in (decompress)
    seconds: float = 0.0
    times: list = field(default_factory=list)


class Runner:
    """One cell's set-up, window and check, on ``device`` ("cuda" or, in
    tests, "cpu") over ``chips`` devices. ``overrides`` replaces knobs of
    the program's calls (the control); the reference keeps the
    configuration's."""

    def __init__(self, cfg: dict, trf: dict, seed: int, chips: int = 1,
                 device: str = "cuda", overrides: dict | None = None):
        check_spec(trf)
        self.cfg, self.trf, self.seed = cfg, trf, int(seed)
        self.chips, self.device = chips, device
        self.knobs = knobs_of(cfg)
        self.kwargs = port_kwargs({**cfg["knobs"], **(overrides or {})})
        self.calls = {op: Calls() for op in trf["ops"]}
        self.samples = {op: Sample(int(trf.get("sample", {}).get(op, 1)),
                                   self.seed, op) for op in trf["ops"]}
        self.failed = 0
        self.errors: list[str] = []
        self.frames: dict[int, tuple[bytes, int]] = {}  # b: (frame, it)
        self.prepared: dict[int, bytes] = {}
        self.it = 0  # iterations of the traffic's ops so far

    # --- set-up -------------------------------------------------------------

    def setup(self) -> None:
        """Make the inputs, build and warm the program on this cell's calls,
        compress the buffers a loop needs ready."""
        from entropy_coders_tpu_torch import frame as F

        self.F = F
        if self.chips > 1:
            from entropy_coders_tpu_torch.parallel.sharding import (
                block_sharding, default_mesh)
            import torch

            mesh = (default_mesh(self.chips) if self.device == "cuda"
                    else (torch.device(self.device),) * self.chips)
            self.kwargs["sharding"] = block_sharding(mesh)
            self.cards = list(range(self.chips))
        else:
            self.kwargs["device"] = self.device
            self.cards = [0]
        size = int(self.cfg["size"])
        t0 = time.perf_counter()
        n_bufs = max(1, -(-int(self.trf.get("input_bytes", size)) // size))
        self.bufs = [data.make(self.cfg["data"], size, self.seed, b)
                     for b in range(n_bufs)]
        self.phases = {"inputs": time.perf_counter() - t0}
        t0 = time.perf_counter()
        if self.trf.get("prepare"):
            for b, buf in enumerate(self.bufs):
                self.prepared[b] = self._compress(buf)
                self.frames[b] = (self.prepared[b], -1)
        if "read" in self.trf["ops"]:
            self.reads = Reads(self.trf["read"], size, self.seed)
        self.relabel = (Relabel(self.seed, self.bufs)
                        if "compress" in self.trf["ops"] else None)
        # warm-up: one call of each op (the first builds and loads the
        # kernels), none of it in the window or the sample
        ops = self.trf["ops"]
        frame = self.prepared.get(0)
        if frame is None or "compress" in ops:
            frame = self._compress(self.bufs[0])
        if "decompress" in ops:
            self._decompress(frame)
        if "read" in ops:
            self._decompress(frame, start=size // 3, length=min(size, 4096))
        self._sync()
        self.phases["warm-up"] = time.perf_counter() - t0

    def _compress(self, buf) -> bytes:
        return self.F.compress(buf, **self.kwargs)

    def _decompress(self, frame, **rng):
        kw = {k: v for k, v in self.kwargs.items()
              if k in ("device", "sharding")}
        return self.F.decompress(frame, **kw, **rng)

    def _sync(self) -> None:
        if self.device == "cuda":
            import torch

            for c in self.cards:
                torch.cuda.synchronize(c)

    # --- the window ---------------------------------------------------------

    def window(self, seconds: float, trace: bool = False) -> None:
        """Run the loop for ``seconds`` (under ``torch.profiler`` with
        ``trace``), each call in a ``bench.<op>`` range when traced. The
        objects set-up left are frozen out of the collector's scans, so
        that the window's collections walk only what the calls make."""
        gc.collect()
        gc.freeze()
        if self.device == "cuda":
            import torch

            for c in self.cards:
                torch.cuda.reset_peak_memory_stats(c)
        self.prof = None
        faults0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        if trace:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            t_end = time.perf_counter() + seconds
            prof = profile(activities=acts)
            prof.start()
            self._loop(seconds, trace=True,
                       calls=int(self.trf.get("trace_calls", 0)) or None)
            self._sync()
            prof.stop()
            self.prof = prof
            # the rest of the window runs untraced
            left = t_end - time.perf_counter()
            if left > 0:
                self._loop(left, trace=False)
        else:
            self._loop(seconds, trace=False)
        self.faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - faults0
        self.memory_peak = 0
        if self.device == "cuda":
            import torch

            self.memory_peak = max(torch.cuda.max_memory_allocated(c)
                                   for c in self.cards)

    def _loop(self, seconds: float, trace: bool, calls: int | None = None):
        """Whole iterations of the traffic's ops until ``seconds`` have
        passed (or ``calls`` calls are made), each traced call in a
        range."""
        from torch.profiler import record_function

        t_end = time.perf_counter() + seconds
        made = 0
        while True:
            b = self.it % len(self.bufs)
            for op in self.trf["ops"]:
                if trace:
                    with record_function(tracing.call_range(op)):
                        self._call(op, b)
                else:
                    self._call(op, b)
                made += 1
            self.it += 1
            if time.perf_counter() >= t_end or (calls and made >= calls):
                return

    def input_of(self, b: int, it: int) -> np.ndarray:
        """The input that iteration ``it`` (-1: set-up) compresses from
        buffer ``b``: the buffer rotated and relabeled by the iteration's
        draw, written into one array that every iteration reuses."""
        if it < 0 or self.relabel is None:
            return self.bufs[b]
        return self.relabel.apply(it)

    def _call(self, op: str, b: int) -> None:
        rec, it = self.calls[op], self.it
        try:
            if op == "compress":
                buf = self.input_of(b, it)
                t0 = time.perf_counter()
                out = self._compress(buf)
                dt = time.perf_counter() - t0
                self.frames[b] = (out, it)
                rec.raw += len(buf)
                rec.frame += len(out)
                self.samples[op].offer((b, it, out))
            elif op == "decompress":
                frame, made = self.frames[b]
                t0 = time.perf_counter()
                out = self._decompress(frame)
                dt = time.perf_counter() - t0
                rec.raw += len(out)
                rec.frame += len(frame)
                self.samples[op].offer((b, made, out))
            else:
                start, length = self.reads.next()
                frame, made = self.frames[b]
                t0 = time.perf_counter()
                out = self._decompress(frame, start=start, length=length)
                dt = time.perf_counter() - t0
                rec.raw += len(out)
                self.samples[op].offer((b, made, start, length, out))
        except Exception as e:  # a call that fails is counted, not fatal
            self.failed += 1
            if len(self.errors) < 5:
                self.errors.append(f"{op}: {type(e).__name__}: {e}")
            return
        rec.n += 1
        rec.seconds += dt
        rec.times.append(dt)

    # --- after the window -----------------------------------------------------

    def run_record(self) -> dict:
        """What the metric files read."""
        return {"calls": {op: vars(c) for op, c in self.calls.items()},
                "cards": self.cards, "setup_s": getattr(self, "setup_s", 0.0)}

    def trace_summary(self):
        """The window's ``tracing.Trace`` and summary (None untraced)."""
        if self.prof is None:
            return None, None
        tr = tracing.from_profiler(self.prof)
        spans = [e for e in tr.events
                 if e.kind == "range" and e.name.startswith("bench.")]
        if spans:
            tr.t0 = min(e.start for e in spans)
            tr.t1 = max(e.end for e in spans)
        self.prof = None
        return tr, tracing.summary(tr, self.cards)

    def check(self) -> dict:
        """The numbers compared, each {"value", "limit"}: wrong blocks in
        the sampled frames (and the set-up frames a loop reads), wrong bytes
        in the sampled decompress answers, wrong sampled reads, failed
        calls. Every limit is 0: the comparisons are exact."""
        blocks_wrong = 0
        frames = [(b, -1, f) for b, f in self.prepared.items()]
        frames += self.samples.get("compress", Sample(0, 0, "")).kept
        for b, it, fr in frames:
            buf = self._given(b, it)
            ids = check_blocks(-(-len(buf) // self.knobs.block_size),
                               self.knobs.block_size, len(buf), self.chips,
                               self.cfg.get("check_blocks"), self.seed + b)
            rep = check_frame(fr, buf, self.knobs, ids)
            blocks_wrong += rep.wrong
            for why in (rep.frame_wrong + rep.blocks_wrong)[:3]:
                print(f"reference: buffer {b}, iteration {it}: {why}",
                      file=sys.stderr)
        out = {"blocks_wrong": blocks_wrong}
        if "decompress" in self.samples:
            wrong = 0
            for b, it, got in self.samples["decompress"].kept:
                wrong += _bytes_wrong(got, self._given(b, it))
            out["bytes_wrong"] = wrong
        if "read" in self.samples:
            out["reads_wrong"] = sum(
                _bytes_wrong(got, self._given(b, it)[s: s + n]) > 0
                for b, it, s, n, got in self.samples["read"].kept)
        out["calls_failed"] = self.failed
        return {k: {"value": int(v), "limit": 0} for k, v in out.items()}


    def _given(self, b: int, it: int) -> np.ndarray:
        """The input of iteration ``it`` of buffer ``b``, made anew from the
        seed (the window's array has since been overwritten)."""
        if it < 0 or self.relabel is None:
            return self.bufs[b]
        return self.relabel.apply(it, fresh=True)


def _bytes_wrong(got, want: np.ndarray) -> int:
    got = np.frombuffer(got, np.uint8)
    n = min(len(got), len(want))
    return int(np.count_nonzero(got[:n] != want[:n])) + abs(len(got) - len(want))


def run_cell(bench: dict, cell: registry.Cell, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             root=registry.HERE, overrides: dict | None = None,
             log=lambda s: print(s, file=sys.stderr)) -> dict:
    """One run of ``cell``: the result's dict (the line the benchmark
    prints), and, under the key "checks", the numbers compared. ``t_start``
    is the process's start on ``time.monotonic``'s clock (default now)."""
    cfg = registry.config(cell.config, root)
    trf = registry.traffic(cell.traffic, root)
    t_start = time.monotonic() if t_start is None else t_start
    r = Runner(cfg, trf, seed, cell.chips, device, overrides)
    r.setup()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    r.setup_s = time.monotonic() - t_start
    log(f"set-up {r.setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in r.phases.items())
        + f"); window {seconds} s, trace {int(trace)}")
    r.window(seconds, trace)
    tr, summ = r.trace_summary()
    run = r.run_record()
    metrics = {}
    for m in registry.metrics_of(bench, cell.name, trace):
        v = registry.reader(m["name"], root)(tr, run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    r.frames.clear()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = r.check()
    log(f"reference check {time.perf_counter() - t0:.3f} s")
    for e in r.errors:
        log(f"failed call: {e}")
    log(f"window: {r.faults} minor page faults")
    for op, c in r.calls.items():
        if c.times:
            q = np.percentile(np.asarray(c.times) * 1e3, [0, 10, 50, 90, 100])
            log(f"{op}: {c.n} calls, ms min/p10/p50/p90/max "
                + " / ".join(f"{v:.2f}" for v in q))
    attempted = sum(c.n for c in r.calls.values()) + r.failed
    correct = (attempted > 0 and all(c.n for c in r.calls.values())
               and all(v["value"] <= v["limit"] for v in checks.values()))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": _device_name(device), "count": cell.chips,
           "memory_peak_bytes": int(r.memory_peak)}
    if summ is not None:
        dev["busy_s"] = summ["busy_s"]
        dev["window_s"] = summ["window_s"]
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": r.failed, "metrics": metrics, "device": dev}
    if summ is not None:
        out["breakdown"] = summ["breakdown"]
    out["checks"] = checks
    return out


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded modules that a run must not load: "
                         + ", ".join(names))
        self.names = names


def _device_name(device: str) -> str:
    if device != "cuda":
        return device
    import torch

    return torch.cuda.get_device_name(0)

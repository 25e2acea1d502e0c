"""The readers of the program's own call ranges and counters
(``call_readers``) on synthetic traces whose numbers are worked out by
hand: the fixture of ``test_ect_bench_metrics`` with the port's
``ect.<op>`` range inside each ``bench.<op>`` call, a call that holds 30 ms
of the harness's work before the port's range, a four-card round of share
dispatches, and the counters. A program without these ranges or counters
(an older port) reads None and raises nothing; and the readers that were
there read the same with the new ranges in the trace."""

import sys
import types

import pytest

from ect_bench import call_readers, registry, tracing
from ect_bench.tests.test_ect_bench_metrics import EVENTS, RUN

MS = 1_000_000  # ns

# the port's whole-call range inside each of the fixture's calls, and a
# mesh share's ranges inside the first compress's stages
PORT = [
    ("range", "ect.compress", MS // 2, 9 * MS + MS // 2, 1),
    ("range", "ect.compress", 20 * MS + MS // 2, 29 * MS + MS // 2, 1),
    ("range", "ect.decompress", 40 * MS + MS // 2, 59 * MS + MS // 2, 1),
    ("range", "ect.compress.share_dispatch.0", MS, 2 * MS + MS // 2, 1),
    ("range", "ect.compress.share_drain.0", 5 * MS, 6 * MS, 1),
]
NEW = ("host_other_ms", "call_idle", "host_alloc_MB", "mesh_dispatch_lag_ms")
OLD = ("host_ms", "copy_ms", "kernel_roofline", "device_idle",
       "mesh_overlap")


def read(name, events, run=RUN):
    return registry.reader(name)(tracing.Trace(events), run)


@pytest.mark.parametrize("op", ["compress", "decompress"])
@pytest.mark.parametrize("metric", OLD)
def test_every_existing_metric_reads_the_same_with_the_ports_ranges(metric,
                                                                    op):
    name = f"{metric}.{op}"
    assert read(name, EVENTS + PORT) == read(name, EVENTS)


def test_host_other_ms_is_the_call_ranges_own_time():
    # compress: 9 ms less h2d (1-3) and frame (5-9) = 3 ms; 9 ms less frame
    # (21-24) = 6 ms; per call 4.5. decompress: 19 less parse (41-45)
    assert read("host_other_ms.compress", EVENTS + PORT) == pytest.approx(4.5)
    assert read("host_other_ms.decompress", EVENTS + PORT) == pytest.approx(
        15.0)


def test_call_idle_over_the_ports_ranges():
    # compress ranges 0.5-9.5 and 20.5-29.5 (18 ms): card 0 busy 1-4 and
    # 22-23 (4 ms), card 1 2-4 (2 ms)
    want = 100 * ((1 - 4 / 18) + (1 - 2 / 18)) / 2
    assert read("call_idle.compress", EVENTS + PORT) == pytest.approx(want)
    # decompress 40.5-59.5: card 0 50-54, card 1 46-48
    want = 100 * ((1 - 4 / 19) + (1 - 2 / 19)) / 2
    assert read("call_idle.decompress", EVENTS + PORT) == pytest.approx(want)


def test_call_idle_leaves_out_the_harness_work_that_device_idle_holds():
    # one compress: 30 ms of the harness's input making, then the port's
    # 10 ms call, 5 ms of it on the card
    events = [("range", "bench.compress", 0, 40 * MS, 1),
              ("range", "ect.compress", 30 * MS, 40 * MS, 1),
              ("kernel", "pl_encode", 32 * MS, 37 * MS, 0)]
    run = {"calls": {"compress": {"n": 1, "raw": 1, "frame": 1}},
           "cards": [0]}
    assert read("device_idle.compress", events, run) == pytest.approx(87.5)
    assert read("call_idle.compress", events, run) == pytest.approx(50.0)
    assert read("host_other_ms.compress", events, run) == pytest.approx(10.0)


def test_host_alloc_mb_per_call_from_the_counters(monkeypatch):
    counters = {"calls.compress": 2, "calls.decompress": 4,
                "host_bytes.compress.frame": 3_000_000,
                "host_bytes.compress.sections": 1_000_000,
                "host_bytes.decompress.output": 8_000_000}
    run = dict(RUN, counters=counters)
    assert read("host_alloc_MB.compress", EVENTS, run) == pytest.approx(2.0)
    assert read("host_alloc_MB.decompress", EVENTS, run) == pytest.approx(
        2.0)
    # without counters in the run: the loaded port's own
    port = types.ModuleType("profiling")
    port.counters = counters
    monkeypatch.setitem(sys.modules,
                        "entropy_coders_tpu_torch.utils.profiling", port)
    assert read("host_alloc_MB.compress", EVENTS) == pytest.approx(2.0)
    # a port that keeps no counters, or has made no call of the op
    monkeypatch.setitem(sys.modules,
                        "entropy_coders_tpu_torch.utils.profiling",
                        types.ModuleType("profiling"))
    assert read("host_alloc_MB.compress", EVENTS) is None
    assert call_readers.host_alloc_mb(None, run, "read") is None


def test_mesh_dispatch_lag_sums_each_rounds_last_less_first():
    share = "ect.compress.share_dispatch."
    events = [("range", "bench.compress", 0, 300 * MS, 1),
              ("range", "ect.compress", 100 * MS, 200 * MS, 1),
              # round 1: ends 102, 104, 105, 108 -> 6 ms
              ("range", share + "0", 101 * MS, 102 * MS, 1),
              ("range", share + "1", 102 * MS, 104 * MS, 1),
              ("range", share + "2", 104 * MS, 105 * MS, 1),
              ("range", share + "3", 105 * MS, 108 * MS, 1),
              ("range", "ect.compress.share_drain.0", 110 * MS, 120 * MS, 1),
              # round 2: ends 151, 153 -> 2 ms
              ("range", share + "0", 150 * MS, 151 * MS, 1),
              ("range", share + "1", 151 * MS, 153 * MS, 1),
              # a share range outside the port's call is not read
              ("range", share + "1", 250 * MS, 260 * MS, 1)]
    run = {"calls": {"compress": {"n": 1}}, "cards": [0, 1, 2, 3]}
    assert read("mesh_dispatch_lag_ms.compress", events, run) == \
        pytest.approx(8.0)
    # one card: every round one share, no lag
    assert read("mesh_dispatch_lag_ms.compress", EVENTS + PORT) == 0.0
    assert read("mesh_dispatch_lag_ms.decompress", EVENTS + PORT) is None


@pytest.mark.parametrize("op", ["compress", "decompress"])
@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_ranges_and_counters_reads_none(metric, op,
                                                              monkeypatch):
    monkeypatch.delitem(sys.modules,
                        "entropy_coders_tpu_torch.utils.profiling",
                        raising=False)
    assert read(f"{metric}.{op}", EVENTS) is None

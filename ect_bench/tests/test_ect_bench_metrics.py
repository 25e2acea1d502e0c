"""The per-layer readers, the roofline yardstick and the trace summary on a
small synthetic trace whose numbers are worked out by hand, the Chrome-format
reading on a hand-written trace, and on the card a traced run's events."""

import json

import pytest

from ect_bench import registry, roofline, tracing

MS = 1_000_000  # ns

# two compress calls (0-10 ms, 20-30 ms) and one decompress (40-60 ms) on
# thread 1; ranges nested as the program nests its stages; two cards
EVENTS = [
    ("range", "bench.compress", 0, 10 * MS, 1),
    ("range", "ect.compress.h2d", 1 * MS, 3 * MS, 1),
    ("op", "aten::copy_", 1 * MS, 2 * MS, 1),  # 1 ms of the 2 is an op
    ("range", "ect.compress.frame", 5 * MS, 9 * MS, 1),
    ("range", "bench.compress", 20 * MS, 30 * MS, 1),
    ("range", "ect.compress.frame", 21 * MS, 24 * MS, 1),
    ("range", "bench.decompress", 40 * MS, 60 * MS, 1),
    ("range", "ect.decompress.parse", 41 * MS, 45 * MS, 1),
    ("memcpy", "Memcpy HtoD", 1 * MS, 2 * MS, 0),
    ("kernel", "pl_encode", 2 * MS, 4 * MS, 0),
    ("kernel", "pl_encode", 2 * MS, 4 * MS, 1),  # card 1 at the same time
    ("kernel", "pl_encode", 22 * MS, 23 * MS, 0),
    ("memcpy", "Memcpy DtoH", 50 * MS, 54 * MS, 0),
    ("kernel", "lane_decode", 46 * MS, 48 * MS, 1),
]
RUN = {"calls": {"compress": {"n": 2, "raw": 3_350_000_000 * 2 // 1000,
                              "frame": 0},
                 "decompress": {"n": 1, "raw": 1000, "frame": 1000}},
       "cards": [0, 1]}


def read(name, trace=None):
    return registry.reader(name)(trace or tracing.Trace(EVENTS), RUN)


def test_host_ms_is_the_ranges_own_time_per_call():
    # compress: h2d 2 - 1 (its operator) + frame 4 + frame 3 = 8 ms / 2
    assert read("host_ms.compress") == pytest.approx(4.0)
    assert read("host_ms.decompress") == pytest.approx(4.0)
    assert read("host_ms.read") is None  # no read calls: nothing to read


def test_copy_ms_per_call():
    assert read("copy_ms.compress") == pytest.approx(0.5)
    assert read("copy_ms.decompress") == pytest.approx(4.0)


def test_kernel_roofline_against_the_algorithms_bytes():
    # 6.7 MB at 3.35 TB/s is 2 us; kernels in compress calls: 2 + 2 + 1 ms
    want = 100 * (6_700_000 / 3.35e12) / 5e-3
    assert read("kernel_roofline.compress") == pytest.approx(want)
    assert roofline.call_bytes("compress", 10, 4) == 14
    assert roofline.share_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert roofline.share_pct(1, 0) is None


def test_device_idle_is_the_mean_over_cards():
    # compress calls 20 ms: card 0 busy 1-4 and 22-23 (4 ms), card 1 2 ms
    want = 100 * ((1 - 4 / 20) + (1 - 2 / 20)) / 2
    assert read("device_idle.compress") == pytest.approx(want)


def test_mesh_overlap_is_union_over_sum():
    # compress: card 0 busy 1-4, 22-23; card 1 2-4: union 4 ms, sum 6 ms
    assert read("mesh_overlap.compress") == pytest.approx(100 * 4 / 6)
    one = dict(RUN, cards=[0])
    assert registry.reader("mesh_overlap.compress")(
        tracing.Trace(EVENTS), one) is None


def test_end_to_end_readers():
    run = {"calls": {"compress": {"n": 2, "raw": 4_000_000_000, "frame": 2e9,
                                  "seconds": 2.0, "times": [1.0, 1.0]},
                     "read": {"n": 20, "raw": 20, "frame": 0, "seconds": 1,
                              "times": [i / 1000 for i in range(1, 21)]}},
           "setup_s": 7.5}
    r = lambda name: registry.reader(name)(None, run)  # noqa: E731
    assert r("compress_GBps") == pytest.approx(2.0)
    assert r("ratio") == pytest.approx(0.5)
    assert r("read_p95_ms") == pytest.approx(19.05)
    assert r("setup_s") == 7.5
    assert r("decompress_GBps") is None


def test_summary_busy_window_and_breakdown():
    tr = tracing.Trace(EVENTS)
    s = tracing.summary(tr, [0, 1])
    # card 0 busy 1-4, 22-23, 50-54 (8 ms); card 1 2-4, 46-48 (4 ms)
    assert s["busy_s"] == pytest.approx(6e-3)
    assert s["window_s"] == pytest.approx(60e-3)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["pl_encode"] == pytest.approx(5e-3)
    idle = dict(s["breakdown"]["idle_gaps"])
    # each gap is named by the range at its middle: on card 1 the gap 40-46
    # of the decompress call lies in parse (41-45); card 0's 40-50 does not
    assert idle["ect.decompress.parse"] == pytest.approx(6 / 2 * 1e-3)
    # idle inside the calls: card 0 32 ms, card 1 36 ms, averaged
    assert sum(idle.values()) == pytest.approx(34e-3)


def test_reading_a_chrome_trace():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "bench.compress",
         "ts": 1000.0, "dur": 10000.0, "pid": 7, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1500.5,
         "dur": 1.25, "pid": 7, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 2000.0, "dur": 5.0,
         "pid": 0, "tid": 7, "args": {"device": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 3000,
         "dur": 2, "pid": 1, "tid": 9},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1600, "dur": 3, "pid": 7, "tid": 7},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1, "pid": 0},
    ]}
    tr = tracing.from_chrome(json.loads(json.dumps(doc)))
    kinds = [(e.kind, e.where, e.start, e.end) for e in tr.events]
    assert kinds == [("range", 7, 1_000_000, 11_000_000),
                     ("op", 7, 1_500_500, 1_501_750),
                     ("kernel", 2, 2_000_000, 2_005_000),
                     ("memcpy", 1, 3_000_000, 3_002_000)]
    assert tr.devices() == [1, 2]


def test_interval_helpers():
    assert tracing.union([(5, 7), (1, 3), (2, 4)]) == [(1, 4), (5, 7)]
    assert tracing.clip([(0, 10)], [(2, 3), (5, 20)]) == [(2, 3), (5, 10)]
    assert tracing.gaps([(2, 3), (5, 6)], [(0, 10)]) == [(0, 2), (3, 5),
                                                         (6, 10)]
    assert list(tracing.inside([0, 2, 5, 9], [(1, 3), (5, 6)])) == [
        False, True, True, False]


@pytest.mark.card
def test_a_traced_window_on_the_card_sees_kernels_and_copies(card):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.arange(1 << 20, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(tracing.call_range("compress")):
            y = (x.to(card) * 2).cpu()
        torch.cuda.synchronize()
    tr = tracing.from_profiler(prof)
    assert y[3] == 6
    assert tr.calls("compress")
    assert tr.device_events(kinds=("kernel",))
    assert tr.device_events(kinds=("memcpy",))

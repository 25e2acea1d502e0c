"""The size-parity cell's pieces on the CPU: a tiny cell of the parity
configuration's knobs (bit-packed lanes, a crc32 a block, L=11) run through
the harness reads ``correct``, its control (L=10) does not, and a traced
run reads the four stage metrics; the stage readers (``stage_readers``) on
synthetic traces worked out by hand, None where the ranges are absent, and
the readers that were there read the same with the new ranges nested in
the stages that hold them."""

import json

import pytest

from ect_bench import registry, tracing
from ect_bench.harness import run_cell
from ect_bench.tests.test_ect_bench_call_metrics import PORT
from ect_bench.tests.test_ect_bench_metrics import EVENTS, RUN
from ect_bench.tests.tiny import make_root

MS = 1_000_000  # ns
CELL = "parity_128m.roundtrip"
TINY_CELL = "tiny_parity.roundtrip"
STAGES = ("crc_ms", "size_table_ms")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny copy of the benchmark with a parity cell of its own: the
    parity configuration at 32 KiB blocks and k=256, four blocks and a
    ragged tail, in every metric list that names the parity cell."""
    root, bench = make_root(tmp_path_factory.mktemp("bench"))
    cfg = registry.config("parity_128m")
    cfg.update(size=4 * 32768 + 3000,
               knobs=dict(cfg["knobs"], block_size=32768, k=256))
    (root / "configs" / "tiny_parity.json").write_text(json.dumps(cfg))
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny_parity",
                               "traffic": "tiny_roundtrip", "chips": 1,
                               "why": "a tiny parity cell for the CPU"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_CELL)
    return root, bench


def run(tiny, trace=False, **kw):
    root, bench = tiny
    return run_cell(bench, registry.cell(bench, TINY_CELL), 2**31 + 5, 0.5,
                    trace, "cpu", root=root, log=lambda s: None, **kw)


def test_the_tiny_parity_cell_is_correct(tiny):
    res = run(tiny)
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["metrics"]["ratio"]["value"] < 0.5


def test_its_control_is_not_correct(tiny):
    ctl = registry.config("tiny_parity", tiny[0])["control"]
    res = run(tiny, overrides=ctl)
    assert not res["correct"]
    assert res["checks"]["blocks_wrong"]["value"] > 0


def test_a_traced_run_reads_the_stage_metrics(tiny):
    res = run(tiny, trace=True)
    assert res["correct"]
    for name in STAGES:
        for op in ("compress", "decompress"):
            assert res["metrics"][f"{name}.{op}"]["value"] > 0, (name, op)


def test_the_parity_cell_lists_the_stage_metrics_alone():
    bench = registry.load()
    for m in bench["per_layer"]:
        if m["name"].split(".")[0] in STAGES:
            assert m["workloads"] == [CELL]
            assert m["moves"] == m["name"].split(".")[1] + "_GBps"


# the fixture's first compress (0-10 ms) holds a crc range in its frame
# stage (5-9 ms) and two size tables; its decompress (40-60 ms) a crc range
# in an output stage and a size table in a checks stage
STAGE_EVENTS = [
    ("range", "ect.compress.assemble", 4 * MS, 5 * MS, 1),
    ("range", "ect.compress.size_table", 4 * MS, 4 * MS + MS // 4, 1),
    ("range", "ect.compress.size_table", 4 * MS + MS // 2,
     4 * MS + 3 * MS // 4, 1),
    ("range", "ect.compress.crc", 6 * MS, 8 * MS, 1),
    ("op", "aten::empty", 7 * MS, 7 * MS + MS // 2, 1),
    ("range", "ect.decompress.checks", 46 * MS, 47 * MS, 1),
    ("range", "ect.decompress.size_table", 46 * MS, 46 * MS + MS // 10, 1),
    ("range", "ect.decompress.output", 55 * MS, 59 * MS, 1),
    ("range", "ect.decompress.crc", 55 * MS, 58 * MS, 1),
    # a crc range outside every call is not read
    ("range", "ect.compress.crc", 70 * MS, 80 * MS, 1),
]


def read(name, events, run=RUN):
    return registry.reader(name)(tracing.Trace(events), run)


@pytest.mark.parametrize("name,want", [
    # 2 ms less its 0.5 ms operator, over two calls
    ("crc_ms.compress", 0.75),
    # two 0.25 ms tables over two calls
    ("size_table_ms.compress", 0.25),
    ("crc_ms.decompress", 3.0),
    ("size_table_ms.decompress", 0.1),
])
def test_stage_ms_is_the_ranges_own_time_per_call(name, want):
    assert read(name, EVENTS + STAGE_EVENTS) == pytest.approx(want)


@pytest.mark.parametrize("op", ["compress", "decompress"])
@pytest.mark.parametrize("name", STAGES)
def test_a_trace_without_the_ranges_reads_none(name, op):
    assert read(f"{name}.{op}", EVENTS) is None
    # a range outside the calls, or no call of the op, reads None too
    outside = [("range", f"ect.{op}.{name[:-3]}", 90 * MS, 95 * MS, 1)]
    assert read(f"{name}.{op}", EVENTS + outside) is None
    calls = {"calls": {}, "cards": [0]}
    assert read(f"{name}.{op}", STAGE_EVENTS, calls) is None


@pytest.mark.parametrize("op", ["compress", "decompress"])
@pytest.mark.parametrize("metric", ["host_ms", "copy_ms", "kernel_roofline",
                                    "device_idle", "host_other_ms",
                                    "call_idle"])
def test_existing_readers_read_the_same_with_the_stage_ranges(metric, op):
    """The new ranges only split the self time of the stages that hold
    them: ``host_ms`` keeps its total, and no other reader moves. Both
    traces hold the port's call ranges and the stages and operators around
    the new ranges."""
    base = EVENTS + PORT + [e for e in STAGE_EVENTS
                            if not e[1].endswith((".crc", ".size_table"))]
    name = f"{metric}.{op}"
    got = read(name, EVENTS + PORT + STAGE_EVENTS)
    assert got is not None and got == pytest.approx(read(name, base))

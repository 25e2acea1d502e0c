"""The harness is driven by data: a configuration, a traffic mix and a
metric are files found by their names, and a new cell is new files and a
new entry."""

import json

import pytest

from ect_bench import registry
from ect_bench.harness import run_cell
from ect_bench.traffic import Reads, Sample, check_spec


def test_every_cell_of_the_benchmark_has_its_files():
    bench = registry.load()
    for c in registry.cells(bench):
        cfg = registry.config(c.config)
        check_spec(registry.traffic(c.traffic))
        assert cfg["chips"] == c.chips
        for trace in (False, True):
            for m in registry.metrics_of(bench, c.name, trace):
                assert callable(registry.reader(m["name"]))


def test_a_new_cell_from_new_files_only(tmp_path):
    """A dummy configuration and traffic mix added as files, with one new
    entry: the harness lists the cell and runs it (on the CPU)."""
    from ect_bench.tests.tiny import make_root

    root, bench = make_root(tmp_path)
    (root / "configs" / "dummy.json").write_text(json.dumps({
        "data": {"kind": "gen_sequence", "prob": 0.3}, "size": 3 * 16384 + 9,
        "knobs": {"block_size": 16384, "k": 128, "table_log": 9},
        "chips": 1, "reduced": []}))
    (root / "traffic" / "dummy_mix.json").write_text(json.dumps({
        "ops": ["compress"], "sample": {"compress": 1}}))
    bench["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "added by files only"})
    for m in bench["end_to_end"]:
        if m["name"] in ("compress_GBps", "ratio"):
            m["workloads"].append("dummy.dummy_mix")
    assert "dummy.dummy_mix" in [c.name for c in registry.cells(bench)]
    res = run_cell(bench, registry.cell(bench, "dummy.dummy_mix"), 5, 0.3,
                   False, "cpu", root=root, log=lambda s: None)
    assert res["correct"]
    assert set(res["metrics"]) == {"compress_GBps", "ratio", "setup_s"}


def test_missing_pieces_are_named():
    with pytest.raises(FileNotFoundError, match="nosuch"):
        registry.config("nosuch")
    with pytest.raises(FileNotFoundError, match="nosuch"):
        registry.reader("nosuch.metric")
    with pytest.raises(KeyError):
        registry.cell(registry.load(), "nosuch.cell")


@pytest.mark.parametrize("spec", [
    {"ops": []}, {"ops": ["encode"]}, {"ops": ["decompress"]},
    {"ops": ["read"], "prepare": True},
])
def test_traffic_the_loop_cannot_drive_is_refused(spec):
    with pytest.raises(ValueError):
        check_spec(spec)


def test_reads_draw_the_same_lengths_for_every_seed():
    spec = {"length_min": 4096, "length_max": 1 << 20, "grid": 64}
    a, b = Reads(spec, 10**8, 1), Reads(spec, 10**8, 2**40)
    la = sorted(a.next()[1] for _ in range(64))
    lb = sorted(b.next()[1] for _ in range(64))
    assert la == lb and la[0] >= 4096 and la[-1] <= 1 << 20
    starts = [a.next() for _ in range(200)]
    assert all(0 <= s <= 10**8 - n for s, n in starts)


def test_sample_keeps_a_uniform_subset():
    s = Sample(3, 7, "compress")
    for i in range(100):
        s.offer(i)
    assert len(s.kept) == 3 and s.seen == 100
    assert len(set(s.kept)) == 3


def test_relabel_keeps_the_distribution_and_changes_the_bytes():
    import numpy as np

    from ect_bench.traffic import Relabel

    rng = np.random.default_rng(0)
    bufs = [rng.integers(0, 40, 1003, dtype=np.uint8),
            rng.integers(32, 123, 1003, dtype=np.uint8)]
    r = Relabel(2**33 + 5, bufs)
    assert r.key_span == [32, 64]
    outs = [r.apply(it, fresh=True) for it in range(40)]
    assert len({o.tobytes() for o in outs}) == len(outs)
    for it, o in enumerate(outs):
        b, off, key = r.draw(it)
        buf = bufs[b]
        assert sorted(np.bincount(o, minlength=256)) == \
            sorted(np.bincount(buf, minlength=256))
        assert int(o.max()).bit_length() == int(buf.max()).bit_length()
        assert np.array_equal(r.apply(it), o)  # the reused array
        assert np.array_equal(np.roll(o ^ np.uint8(key), off), buf)

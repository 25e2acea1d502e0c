"""BENCHMARK.json keeps to the shape its check refuses files outside of:
keys, names, units, bounds, lengths, and every named file in place."""

import json
import re
from pathlib import Path

from ect_bench import registry

BENCH = registry.load()
REPO = registry.HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (REPO / p).is_dir()


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    names = [c["name"] for c in BENCH["configs"]]
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)


def test_metrics():
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in e2e}["setup_s"] <= 0.25
    e2e_names = {m["name"] for m in e2e}
    layers = {}
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e_names and LINE.match(m["layer"])
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        moved = next(x for x in e2e if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:  # every cell reports set-up, another e2e, a per-layer
        e = [m for m in e2e if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2
        assert [m for m in per if w in m.get("workloads", cells)]


def test_files_under_paths_are_named_from_name_characters():
    for p in Path(REPO / BENCH["paths"][0]).rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_.-]+$", p.name), p

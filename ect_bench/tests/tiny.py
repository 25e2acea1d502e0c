"""A copy of the benchmark's files with tiny cells beside its own, for runs
of the harness on the CPU (the port's plain versions) in tests."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from ect_bench import registry

HERE = registry.HERE

TINY_KNOBS = {"block_size": 32768, "k": 256,
              "table_log": ["fast", 0.0025], "lanes": True}
TINY = {"tiny": {"data": {"kind": "text"}, "size": 200_000 + 333,
                 "knobs": TINY_KNOBS, "control": {"table_log": ["fast", 0.05]},
                 "check_blocks": None, "chips": 1, "reduced": []},
        "tiny_pl": {"data": {"kind": "gen_sequence", "prob": 0.2},
                    "size": 4 * 32768, "knobs": {"block_size": 32768, "k": 256,
                                                 "table_log": 8, "lanes": True},
                    "control": {"table_log": 7}, "check_blocks": None,
                    "chips": 1, "reduced": []},
        "tiny_mesh": {"data": {"kind": "text"}, "size": 9 * 32768 + 4321,
                      "knobs": {**TINY_KNOBS, "shared_table": True},
                      "control": {"table_log": ["fast", 0.05]},
                      "check_blocks": 6, "chips": 4, "reduced": ["chips"]}}
TRAFFIC = {"tiny_roundtrip": {"input_bytes": 400_000, "ops": ["compress", "decompress"],
                              "sample": {"compress": 2, "decompress": 3}},
           "tiny_reads": {"prepare": True, "ops": ["read"],
                          "read": {"length_min": 512, "length_max": 65536,
                                   "grid": 64},
                          "sample": {"read": 50}, "trace_calls": 20}}
CELLS = [("tiny.roundtrip", "tiny", "tiny_roundtrip", 1),
         ("tiny_pl.roundtrip", "tiny_pl", "tiny_roundtrip", 1),
         ("tiny.range_reads", "tiny", "tiny_reads", 1),
         ("tiny_mesh.roundtrip", "tiny_mesh", "tiny_roundtrip", 4)]


def make_root(tmp: Path) -> tuple[Path, dict]:
    """A copy of the benchmark's configs, traffic and metrics in ``tmp``
    with the tiny cells added as new files only, and the benchmark's entries
    with the tiny cells added to ``workloads`` and to each metric's cells
    (those of the text cells for the tiny text ones)."""
    root = Path(tmp) / "ect_bench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(HERE / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in TINY.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, trf in TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(trf))
    bench = registry.load()
    bench["workloads"] += [{"name": n, "config": c, "traffic": t, "chips": k,
                            "why": "a tiny cell for the CPU tests"}
                           for n, c, t, k in CELLS]
    kin = {"bench_pl_128m.roundtrip": ["tiny_pl.roundtrip", "tiny.roundtrip"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [
                t for w in m["workloads"] for t in kin.get(w, [])]
    return root, bench

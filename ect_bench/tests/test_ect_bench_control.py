"""The readings that set the limits of ``correct``, at a size the CPU
holds: every sound run reads 0 on every number compared, the control reads
above 0 on at least one, so a limit of 0 lies between the two."""

import pytest

from ect_bench import control, registry
from ect_bench.tests.tiny import make_root


@pytest.mark.parametrize("cell", ["tiny.roundtrip", "tiny_pl.roundtrip",
                                  "tiny.range_reads", "tiny_mesh.roundtrip"])
def test_readings_separate_program_and_control(tmp_path, cell):
    root, bench = make_root(tmp_path)
    c = registry.cell(bench, cell)
    ctl = registry.config(c.config, root)["control"]
    prog = control.readings(bench, c, [2**31 + 1, 2**31 + 2], 0.3, None,
                            "cpu", root, log=lambda s: None)
    bad = control.readings(bench, c, [2**31 + 11, 2**31 + 12, 2**31 + 13],
                           0.3, ctl, "cpu", root, log=lambda s: None)
    s = control.summary(prog, bad)
    assert all(r["correct"] for r in prog)
    assert not any(r["correct"] for r in bad)
    assert all(v["lower"] == 0 for v in s.values())
    assert max(v["upper"] for v in s.values()) > 0

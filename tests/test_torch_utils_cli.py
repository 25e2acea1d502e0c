"""The port's utilities (``entropy_coders_tpu_torch.utils``: ``frame_stats``,
``timed``, ``trace``) and CLI (``python -m entropy_coders_tpu_torch``)
against the JAX package's, on the CPU (``ECT_PLATFORM=cpu``).

Tolerance: exact. ``FrameStats`` are compared field by field, CLI output
files byte for byte, ``stat`` output line for line."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu import __main__ as JM  # noqa: E402
from entropy_coders_tpu import frame as JF  # noqa: E402
from entropy_coders_tpu.utils import frame_stats as jax_frame_stats  # noqa: E402
from entropy_coders_tpu_torch import __main__ as M  # noqa: E402
from entropy_coders_tpu_torch import frame as F  # noqa: E402
from entropy_coders_tpu_torch import utils  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "golden"
FRAME_CASES = [c for c in json.loads((GOLDEN / "manifest.json").read_text())
               if c["codec"] == "frame"]


def _same_stats(st, want) -> bool:
    """The port's ``FrameStats`` and the JAX package's (two dataclasses
    with the same fields) agree field by field and property by property."""
    return (dataclasses.asdict(st) == dataclasses.asdict(want)
            and (st.ratio, st.overhead) == (want.ratio, want.overhead))


def _real_data(n=16 << 10) -> bytes:
    """Real text from the repo (SURVEY.md, README.md, FORMAT.md), cycled
    to n bytes."""
    buf = b"".join((ROOT / f).read_bytes()
                   for f in ("SURVEY.md", "README.md", "FORMAT.md"))
    return (buf * (n // len(buf) + 1))[:n]


@pytest.mark.parametrize("case", FRAME_CASES, ids=[c["name"] for c in FRAME_CASES])
def test_frame_stats_equal_jax_on_goldens(case):
    frame = (GOLDEN / case["file"]).read_bytes()
    st = utils.frame_stats(frame)
    assert _same_stats(st, jax_frame_stats(frame))
    assert st.compressed_len == len(frame)


def test_frame_stats_real_text():
    data = _real_data(32 << 10)
    comp = F.compress(data, block_size=16 << 10, k=128, lanes=True,
                      device="cpu")
    st = utils.frame_stats(comp)
    assert _same_stats(st, jax_frame_stats(comp))
    assert st.mode_counts.get("fse_pl", 0) == 2 and st.ratio < 0.75
    assert sum(st.table_log_counts.values()) == 2


def test_timed_helper():
    results = []
    with utils.timed("x", nbytes=1000, results=results):
        pass
    assert results and results[0].seconds >= 0
    assert "x:" in str(results[0])


def test_trace_writes_profile(tmp_path):
    data = np.frombuffer(bytearray(_real_data(8192)), np.uint8)
    with utils.trace(tmp_path / "tr") as prof:
        frame = F.compress(data, block_size=4096, k=128, lanes=True,
                           device="cpu")
    assert F.decompress(frame, device="cpu") == data.tobytes()
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["traceEvents"]
    assert len(prof.key_averages()) > 0


# --- the CLI ---------------------------------------------------------------------

CLI_FLAGS = {
    "checksum": ["--block-size", "4096", "--k", "128", "--checksum"],
    "bit_pack_fast": ["--block-size", "4096", "--k", "128", "--bit-pack",
                      "--table-log", "fast:0.02"],
    "shared_L9": ["--block-size", "4096", "--k", "128", "--shared-table",
                  "--table-log", "9"],
    "no_lanes_auto": ["--block-size", "8192", "--k", "64", "--no-lanes",
                      "--table-log", "auto"],
}


@pytest.mark.parametrize("name", CLI_FLAGS)
def test_cli_matches_jax(tmp_path, monkeypatch, capsys, name):
    """The port's CLI writes the JAX CLI's file for the same flags, decodes
    it, and prints the JAX CLI's ``stat`` lines."""
    monkeypatch.setenv("ECT_PLATFORM", "cpu")
    data = _real_data()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    ours, theirs, back = (tmp_path / f for f in ("o.fset", "j.fset",
                                                  "back.bin"))
    assert M.main(["compress", str(src), str(ours), *CLI_FLAGS[name]]) == 0
    assert JM.main(["compress", str(src), str(theirs), *CLI_FLAGS[name]]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    assert M.main(["decompress", str(ours), str(back)]) == 0
    assert back.read_bytes() == data
    capsys.readouterr()
    M.main(["stat", str(ours)])
    stat = capsys.readouterr().out
    JM.main(["stat", str(ours)])
    assert stat == capsys.readouterr().out
    assert "ratio=" in stat


def test_cli_lanes_file_equals_jax_frame(tmp_path, monkeypatch):
    """Without ``--no-lanes`` the CLI resolves ``lanes`` from its device:
    False on the CPU, as the JAX CLI does on its CPU backend, so the file
    is the JAX package's shared-stream frame."""
    monkeypatch.setenv("ECT_PLATFORM", "cpu")
    data = _real_data(3 * 4096)
    src, dst = tmp_path / "in.bin", tmp_path / "o.fset"
    src.write_bytes(data)
    M.main(["compress", str(src), str(dst), "--block-size", "4096", "--k",
            "128"])
    assert dst.read_bytes() == JF.compress(data, block_size=4096, k=128,
                                           lanes=False)
    assert F._parse_frame(dst.read_bytes()).modes.tolist() == [JF.MODE_FSE] * 3


def test_cli_without_cuda_raises(tmp_path, monkeypatch):
    """No fallback: without ``ECT_PLATFORM=cpu`` the CLI wants CUDA and
    raises where there is none; an unknown platform raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("ECT_PLATFORM", raising=False)
    src, dst = tmp_path / "in.bin", tmp_path / "o.fset"
    src.write_bytes(_real_data(4096))
    with pytest.raises(RuntimeError, match="CUDA"):
        M.main(["compress", str(src), str(dst)])
    with pytest.raises(RuntimeError, match="CUDA"):
        M.main(["warmup", "--mib", "1"])
    assert not dst.exists()
    monkeypatch.setenv("ECT_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="ECT_PLATFORM"):
        M.main(["compress", str(src), str(dst)])


def test_cli_warmup_cpu(monkeypatch, capsys):
    monkeypatch.setenv("ECT_PLATFORM", "cpu")
    assert M.main(["warmup", "--mib", "1", "--block-size", "4096", "--k",
                   "128", "--table-log", "9"]) == 0
    err = capsys.readouterr().err
    assert "warmup L=9: 1 MiB round trip" in err and "on cpu" in err


def test_cli_module_entry_point(tmp_path):
    """``python -m entropy_coders_tpu_torch`` runs in a fresh interpreter."""
    data = _real_data(8192)
    src, dst = tmp_path / "in.bin", tmp_path / "o.fset"
    src.write_bytes(data)
    env = dict(os.environ, ECT_PLATFORM="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "entropy_coders_tpu_torch", "compress",
         str(src), str(dst), "--block-size", "4096", "--k", "128"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "on cpu" in r.stderr
    assert F.decompress(dst.read_bytes(), device="cpu") == data

"""``correct`` on the CPU at tiny sizes: the sound program passes; the
control (the program at the configuration's control knobs) fails; and so
does each fault a cell can have, planted under the harness in the port's
timed path: an answer altered where it is produced, half of the blocks left
out, a stale answer (the state unchanged: on compress, the frame of an
earlier call, as a cache of answers would give), a range read of the wrong
bytes, and the exchange of the mesh's shares left out."""

import pytest

import entropy_coders_tpu_torch.frame as F
from ect_bench import harness, registry
from ect_bench.harness import run_cell
from ect_bench.tests.tiny import make_root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(tiny, cell, seed=2**31 + 3, **kw):
    root, bench = tiny
    return run_cell(bench, registry.cell(bench, cell), seed, 1.0, False,
                    "cpu", root=root, log=lambda s: None, **kw)


def failing(res):
    return {k for k, v in res["checks"].items() if v["value"] > v["limit"]}


@pytest.mark.parametrize("cell", ["tiny.roundtrip", "tiny_pl.roundtrip",
                                  "tiny.range_reads", "tiny_mesh.roundtrip"])
def test_the_sound_program_is_correct(tiny, cell):
    res = run(tiny, cell)
    assert res["correct"] and not failing(res)
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny.roundtrip", "tiny_pl.roundtrip",
                                  "tiny.range_reads", "tiny_mesh.roundtrip"])
def test_the_control_is_not_correct(tiny, cell):
    root, _ = tiny
    cfg = registry.config(cell.split(".")[0], root)
    res = run(tiny, cell, overrides=cfg["control"])
    assert not res["correct"] and "blocks_wrong" in failing(res)


def _wrap(monkeypatch, name, after):
    """Plant ``after`` on the answers of ``F.<name>`` once the window opens
    (set-up runs the program as it is)."""
    real = getattr(F, name)
    state = {"armed": False}

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        return after(out, a, kw, state) if state["armed"] else out

    monkeypatch.setattr(F, name, wrapped)
    real_window = harness.Runner.window

    def window(self, *a, **kw):
        state["armed"] = True
        return real_window(self, *a, **kw)

    monkeypatch.setattr(harness.Runner, "window", window)


def flip_frame_byte(out, a, kw, state):
    b = bytearray(out)
    b[len(b) * 3 // 4] ^= 0x40
    return bytes(b)


def flip_output_byte(out, a, kw, state):
    b = bytearray(out)
    b[len(b) // 2] ^= 1
    return bytes(b)


def half_the_blocks(out, a, kw, state):
    n = len(out) // 2
    return bytes(out[:n]) + bytes(len(out) - n)


def half_the_input(out, a, kw, state):
    """A frame of the first half of the blocks only."""
    data = a[0]
    return F.compress.__wrapped__(data[: len(data) // 2], **kw)


def stale(out, a, kw, state):
    prev, state["prev"] = state.get("prev", out), out
    return prev


def shifted_read(out, a, kw, state):
    if kw.get("length") is None:
        return out
    return F.decompress.__wrapped__(a[0], start=kw["start"] + 1,
                                    length=kw["length"], device="cpu")


@pytest.mark.parametrize("fault,where,cells,caught", [
    (flip_frame_byte, "compress", ["tiny.roundtrip", "tiny_pl.roundtrip",
                                   "tiny_mesh.roundtrip"], "blocks_wrong"),
    (flip_output_byte, "decompress", ["tiny.roundtrip", "tiny_pl.roundtrip",
                                      "tiny_mesh.roundtrip",
                                      "tiny.range_reads"], None),
    (half_the_blocks, "decompress", ["tiny.roundtrip", "tiny_mesh.roundtrip",
                                     "tiny.range_reads"], None),
    (half_the_input, "compress", ["tiny.roundtrip", "tiny_mesh.roundtrip"],
     "blocks_wrong"),
    (stale, "decompress", ["tiny.roundtrip", "tiny_pl.roundtrip",
                           "tiny.range_reads"], None),
    (stale, "compress", ["tiny.roundtrip", "tiny_pl.roundtrip"],
     "blocks_wrong"),
])
def test_a_planted_fault_is_not_correct(tiny, monkeypatch, fault, where,
                                        cells, caught):
    for cell in cells:
        with monkeypatch.context() as m:
            real = getattr(F, where)
            _wrap(m, where, fault)
            getattr(F, where).__wrapped__ = real
            res = run(tiny, cell)
        assert not res["correct"], (fault.__name__, cell)
        want = caught or ("reads_wrong" if "range" in cell else "bytes_wrong")
        assert want in failing(res), (fault.__name__, cell, res["checks"])


def test_a_read_of_the_wrong_range_is_not_correct(tiny, monkeypatch):
    real = F.decompress
    _wrap(monkeypatch, "decompress", shifted_read)
    F.decompress.__wrapped__ = real
    res = run(tiny, "tiny.range_reads")
    assert "reads_wrong" in failing(res)


def test_the_mesh_exchange_left_out_is_not_correct(tiny, monkeypatch):
    """Each share but the first is decoded and never written back: the
    drain of the other cards' blocks is left out."""
    real = F._decode_drain_pl
    first = {}

    def drain(dispatched, items, raw_len, pf, out, out_base):
        key = id(out)
        if first.setdefault(key, items[0][0]) == items[0][0]:
            return real(dispatched, items, raw_len, pf, out, out_base)
        return None

    real_window = harness.Runner.window

    def window(self, *a, **kw):
        monkeypatch.setattr(F, "_decode_drain_pl", drain)
        return real_window(self, *a, **kw)

    monkeypatch.setattr(harness.Runner, "window", window)
    res = run(tiny, "tiny_mesh.roundtrip")
    assert not res["correct"] and "bytes_wrong" in failing(res)


def test_a_failing_call_is_counted_and_not_correct(tiny, monkeypatch):
    def boom(out, a, kw, state):
        raise RuntimeError("planted")

    _wrap(monkeypatch, "decompress", boom)
    res = run(tiny, "tiny_pl.roundtrip")
    assert not res["correct"]
    assert res["failed"] > 0 and "calls_failed" in failing(res)


@pytest.mark.parametrize("cell", ["tiny.roundtrip", "tiny_pl.roundtrip"])
def test_no_two_compress_calls_see_the_same_input(tiny, monkeypatch, cell):
    """Every compress of the window is given bytes of its own, so a cache of
    answers or of tables keyed on the input never hits."""
    import hashlib

    import numpy as np

    real, seen = F.compress, []

    def compress(data, **kw):
        seen.append(hashlib.sha256(np.asarray(data).tobytes()).hexdigest())
        return real(data, **kw)

    real_window = harness.Runner.window

    def window(self, *a, **kw):
        seen.clear()
        monkeypatch.setattr(F, "compress", compress)
        return real_window(self, *a, **kw)

    monkeypatch.setattr(harness.Runner, "window", window)
    res = run(tiny, cell)
    assert res["correct"]
    assert len(seen) >= 3 and len(set(seen)) == len(seen)

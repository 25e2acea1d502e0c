"""The port's bench and graft entry (``entropy_coders_tpu_torch.tools.bench``,
``tools.graft_entry``) against the root ``bench.py`` and
``__graft_entry__.py``, on the CPU.

* The bench: the port's ``main(["--device", "cpu"])`` against the root
  script's ``main()`` (loaded by path, its device probe patched to answer
  yes and ``_marginal`` to one call, so that no interpret-mode timing loop
  runs): both lines' key sets equal, recursively, apart from the port's
  own keys; ``metric``, ``unit``, the sizes and knobs, and the frames'
  sizes and ratios equal exactly (the frames are byte-identical).
* The encode timer's exactness check (``check_encoded``) with the plain B2
  on the CPU sizes' frames in both wire forms, and the decode timer's
  (``check_decoded``): each accepts the frame's own tables and raises
  RuntimeError on swapped ones. Both timers, and the bench, raise without
  CUDA; ``--device cpu`` is the only way to run the bench without it.
* ``entry("cpu")``'s four outputs equal the JAX ``entry()``'s under
  ``jax.jit``; ``block_roundtrip`` gives the block's bytes back.
* ``dryrun_multichip`` on 1, 2 and 4 CPU ranks: its frames equal the JAX
  package's unsharded ``frame.compress`` of the same data and knobs
  (``interpret=True`` for the per-lane frames); and at the knobs a CUDA
  mesh resolves (``lanes=True``), the frames the card's dry run is held
  to in ``chip_smoke.py`` equal the JAX package's.

Tolerance: exact everywhere (integer codec; frame bytes)."""

import contextlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from entropy_coders_tpu import frame as F  # noqa: E402
from entropy_coders_tpu_torch import compress  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.tools import bench as B  # noqa: E402
from entropy_coders_tpu_torch.tools import bench_configs as BC  # noqa: E402
from entropy_coders_tpu_torch.tools import graft_entry as G  # noqa: E402
from entropy_coders_tpu_torch.tools.bench_data import gen_sequence  # noqa: E402
from entropy_coders_tpu_torch.tools.l10_attack import frame_lanes  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# the keys the port's second line adds to the JAX script's (at the top and
# inside "parity")
PORT_ONLY = {"device", "clock", "launches", "cold_start_s",
             "encode_s_device_samples", "decode_enqueue_s",
             "encode_enqueue_s"}
EXACT_LINE1 = ("metric", "unit", "ratio", "parity_ratio",
               "parity_vs_reference_ratio", "parity_config")
EXACT_LINE2 = ("backend", "input_bytes", "compressed_bytes", "ratio",
               "block_size", "k", "table_log")
EXACT_PARITY = ("compressed_bytes", "ratio", "reference_ratio", "k",
                "table_log", "bit_pack")

# the JAX script's CPU sizes (bench.py:278-281)
SIZE, BS, K = 64 << 10, 16 << 10, 256


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def _run(main, *args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(*args)
    return _json_lines(out.getvalue())[-1], _json_lines(err.getvalue())[-1]


@pytest.fixture(scope="module")
def root_lines():
    """The root bench.py's two lines on the CPU (its probe answering yes,
    each ``_marginal`` one call). Its import-time
    ``enable_compilation_cache()`` is opted out of, so that loading it
    leaves the worker's JAX cache settings as ``conftest.py`` made them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ECT_PERSISTENT_CACHE", "0")
        mod = _load("root_bench", ROOT / "bench.py")
    mod._backend_responsive = lambda *a, **k: True

    def one_call(call, n=16, batches=5):
        mod._sync(call())
        return 1e-3, [1e-3]

    mod._marginal = one_call
    assert jax.default_backend() == "cpu"
    return _run(mod.main)


@pytest.fixture(scope="module")
def port_lines():
    return _run(B.main, ["--device", "cpu"])


def _keys(obj, drop):
    """Every key path of ``obj``, the keys in ``drop`` left out."""
    out = set()
    for key, val in obj.items():
        if key in drop:
            continue
        out.add(key)
        if isinstance(val, dict):
            out |= {f"{key}.{sub}" for sub in _keys(val, drop)}
    return out


@pytest.mark.parametrize("line", [0, 1])
def test_bench_keys_equal_root(line, root_lines, port_lines):
    assert _keys(port_lines[line], PORT_ONLY) == _keys(root_lines[line], ())
    assert not PORT_ONLY & _keys(root_lines[line], ())
    if line == 0:
        assert not PORT_ONLY & set(port_lines[0])
    else:
        assert PORT_ONLY <= set(port_lines[1])


def test_bench_frames_equal_root(root_lines, port_lines):
    (r1, r2), (p1, p2) = root_lines, port_lines
    for key in EXACT_LINE1:
        assert p1[key] == r1[key], key
    for key in EXACT_LINE2:
        assert p2[key] == r2[key], key
    for key in EXACT_PARITY:
        assert p2["parity"][key] == r2["parity"][key], key
    assert p2["backend"] == "cpu" and p2["clock"] == "host"
    assert p2["device"] == "cpu"
    assert set(p2["launches"].values()) == {0}  # the plain versions


def test_bench_port_fields(port_lines):
    p1, p2 = port_lines
    assert p1["vs_baseline"] == round(p1["value"] / 10e9, 4)
    for line in (p2, p2["parity"]):
        assert line["decode_s_device_samples"] == [line["decode_s_device"]]
        assert line["encode_s_device_samples"] == [line["encode_s_device"]]
        assert line["decode_enqueue_s"] is None is line["encode_enqueue_s"]
    assert p2["cold_start_s"]["host_library"] >= 0
    assert "cuda_context" not in p2["cold_start_s"]


def _frame(bit_pack):
    data = gen_sequence(0.2, SIZE)
    return compress(data, block_size=BS, k=K, lanes=True, bit_pack=bit_pack,
                    device="cpu"), data


def _swap_blocks(t):
    """Block j's rows from block B-1-j: valid tables, the wrong ones."""
    return None if t is None else t.flip(0).contiguous()


@pytest.mark.parametrize("bit_pack", [False, True])
def test_encode_check_exact(bit_pack):
    frame, data = _frame(bit_pack)
    inp = BC.encode_inputs(frame, data, BS, K, "cpu")
    assert inp.bit_packed == bit_pack and inp.blocks.shape == (4, BS)
    assert inp.tables.dec is None  # the encode half only
    BC.check_encoded(inp, BC.encode_call(inp))
    bad = inp._replace(tables=PL.LaneTables(
        *(_swap_blocks(t) for t in inp.tables)))
    with pytest.raises(RuntimeError, match="the encode"):
        BC.check_encoded(bad, BC.encode_call(bad))


@pytest.mark.parametrize("bit_pack", [False, True])
def test_decode_check_exact(bit_pack):
    frame, data = _frame(bit_pack)
    inp = frame_lanes(frame, data, block_size=BS, k=K, device="cpu")
    BC.check_decoded(inp, PL.decode_call(inp.words, inp.sizes, inp.dec,
                                         L=inp.L, R=inp.R))
    dec = _swap_blocks(inp.dec)
    with pytest.raises(RuntimeError, match="the decode"):
        BC.check_decoded(inp, PL.decode_call(inp.words, inp.sizes, dec,
                                             L=inp.L, R=inp.R))


def test_timers_and_bench_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    frame, data = _frame(False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BC.device_encode_gbps(frame, data, BS, K)
    with pytest.raises(ValueError, match="CUDA device"):
        BC.device_encode_gbps(frame, data, BS, K, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BC.device_decode_gbps(frame, BS, K, data=data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.main([])
    r = subprocess.run([sys.executable, "-m",
                        "entropy_coders_tpu_torch.tools.bench"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA is not available" in r.stderr


@pytest.fixture(scope="module")
def root_graft():
    return _load("root_graft_entry", ROOT / "__graft_entry__.py")


def test_entry_equals_jax(root_graft):
    jfn, jargs = root_graft.entry()
    want = jax.jit(jfn)(*jargs)
    fn, args = G.entry("cpu")
    got = fn(*args)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), w)
    _, meta = G.example_block(device="cpu")
    _, jmeta = root_graft._example_block()
    assert meta["L"] == jmeta["L"] and meta["W"] == jmeta["W"]
    assert G.block_roundtrip("cpu") == meta["data"].tobytes()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_equals_jax(n):
    frames = G.dryrun_multichip(n, "cpu")
    rng = np.random.default_rng(0)
    data = (rng.integers(0, 32, 2 * n * 2048, dtype=np.uint16) ** 2
            % 249).astype(np.uint8)
    want = {"plain": F.compress(data, block_size=2048, k=16),
            "shared": F.compress(data, block_size=2048, k=16,
                                 shared_table=True),
            "lanes": F.compress(data, block_size=2048, k=128, lanes=True,
                                interpret=True),
            "packed": F.compress(data, block_size=2048, k=128, lanes=True,
                                 interpret=True, bit_pack=True)}
    assert frames == want


@pytest.mark.parametrize("name", [name for name, _ in G.DRYRUN_FRAMES])
def test_dryrun_card_knobs_equal_jax(name):
    """On a CUDA mesh ``lanes`` unset means per-lane, as on the JAX
    package's TPU, and sets the table log of ``plain`` and ``shared``: the
    frames chip_smoke.py holds the card's dry run against (the plain
    versions with ``lanes=True``) equal the JAX package's with
    ``lanes=True``."""
    kw = {"lanes": True, **dict(G.DRYRUN_FRAMES)[name]}
    data = G.dryrun_data(2)
    got = compress(data, block_size=G.DRYRUN_BLOCK, device="cpu", **kw)
    assert got == F.compress(data, block_size=G.DRYRUN_BLOCK,
                             interpret=True, **kw)


def test_dryrun_multichip_mesh_size():
    with pytest.raises(RuntimeError, match="need 3 devices"):
        G.dryrun_multichip(3, mesh=(torch.device("cpu"),) * 2)

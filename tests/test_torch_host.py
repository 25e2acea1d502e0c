"""The port's host library (``entropy_coders_tpu_torch.native``, its own copy
of the C++ codec) and its ``normalize`` against the JAX package's
(``entropy_coders_tpu.native``, ``entropy_coders_tpu.normalize``), on the
CPU. Tolerance: exact, byte for byte (integer codec, no rounding).

Also a source scan: no module of the port and not ``chip_smoke.py`` imports
the JAX package, jax, or the root scripts ``bench``, ``bench_configs`` and
``policy_sweep``."""

import ast
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from entropy_coders_tpu import native as jnative  # noqa: E402
from entropy_coders_tpu.normalize import normalize_batch as jax_normalize  # noqa: E402
from entropy_coders_tpu_torch import native  # noqa: E402
from entropy_coders_tpu_torch import normalize as N  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _random_counts(seed, B=24, size=1 << 14):
    """(B, 256) histograms of ``size``-byte blocks: geometric, uniform over
    a random alphabet, and a few symbols only."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(B):
        kind = b % 3
        if kind == 0:
            x = (rng.geometric(0.05 + 0.3 * rng.random(), size) - 1).clip(0, 255)
        elif kind == 1:
            x = rng.integers(0, int(rng.integers(2, 257)), size)
        else:
            x = rng.choice(rng.integers(0, 256, 3), size, p=[0.90, 0.07, 0.03])
        rows.append(np.bincount(x, minlength=256))
    return np.stack(rows).astype(np.uint64), size


def _slow_counts():
    """Hand-made rows of one size that take ``normalize_batch``'s scalar
    rows: 31 singletons beside one big symbol overshoot the table (the
    reference's slow path, src/histogram.rs:144-145), a single symbol
    owning the whole block (its early return), and the first row scaled
    by 2^33 (counts past u32, as a shared table over > 4 GiB has)."""
    size = 1031
    slow = np.zeros(256, np.uint64)
    slow[:31] = 1
    slow[200] = 1000
    single = np.zeros(256, np.uint64)
    single[65] = size
    return [(np.stack([slow, single, slow[::-1].copy()]), size),
            (np.stack([slow << np.uint64(33)]), size << 33)]


POLICIES = [5, 8, 11, 15, "auto", "fast", ("fast", 0.015)]


@pytest.mark.parametrize("policy", POLICIES, ids=str)
@pytest.mark.parametrize("source", ["random", "slow_rows"])
def test_normalize_batch_equal_jax(policy, source, monkeypatch):
    calls = []
    real = native.normalize
    monkeypatch.setattr(native, "normalize",
                        lambda *a: calls.append(1) or real(*a))
    sets = ([_random_counts(7)] if source == "random" else _slow_counts())
    for counts, size in sets:
        tables, logs = N.normalize_batch(counts, size, policy)
        want_t, want_l = jax_normalize(counts, size, policy)
        assert tables.dtype == want_t.dtype and logs.dtype == want_l.dtype
        assert (tables == want_t).all() and (logs == want_l).all()
        assert (tables.sum(1) + 2 * (tables == -1).sum(1)
                == (1 << logs.astype(np.int64))).all()
    if source == "slow_rows":  # the scalar rows went through ect_normalize
        assert calls


@pytest.mark.parametrize("log2", [-1, 5, 9, 12, 15])
def test_native_normalize_equal_jax(log2):
    counts, size = _random_counts(11, B=12)
    for row in list(counts) + [c[0] for c, _ in _slow_counts()[:1]]:
        sz = int(row.sum())
        l2 = log2 if log2 < 0 else max(log2, int(N._min_log2s(row[None])[0]))
        assert [np.asarray(x).tolist() for x in native.normalize(row, sz, l2)] \
            == [np.asarray(x).tolist() for x in jnative.normalize(row, sz, l2)]
    with pytest.raises(ValueError):
        native.normalize(np.eye(256, dtype=np.uint64)[0] * 9, 9, 8)


@pytest.mark.parametrize("policy", [5, 8, 11, 15, "auto"], ids=str)
def test_header_io_equal_jax(policy):
    counts, size = _random_counts(3)
    tables, logs = N.normalize_batch(counts, size, policy)
    tls = N.table_lens(counts)
    for t, l2, tl in zip(tables, logs, tls):
        hdr = native.write_header(t, int(l2), int(tl))
        assert hdr == jnative.write_header(t, int(l2), int(tl))
        got = native.read_header(hdr + b"\x5a" * 7)
        want = jnative.read_header(hdr + b"\x5a" * 7)
        assert (got[0] == want[0]).all() and got[1:] == want[1:]
        assert got[1:] == (int(l2), int(tl), len(hdr))
    with pytest.raises(ValueError):
        native.read_header(b"\xff")


@pytest.mark.parametrize("L", range(5, 16))
def test_build_tables_equal_jax(L):
    # alphabets of at most 2^(L-1) symbols, so the table-length clamp
    # keeps every row at L
    rng = np.random.default_rng(100 + L)
    a, size = min(256, 1 << (L - 1)), 1 << 14
    xs = [rng.integers(0, a, size), rng.integers(0, max(a // 3, 2), size),
          (rng.geometric(0.2, size) - 1).clip(0, a - 1)]
    counts = np.stack([np.bincount(x, minlength=256) for x in xs])
    nt, logs = N.normalize_batch(counts, size, L)
    assert (logs == L).all()
    for got, want in zip(native.build_encode_tables(nt, L),
                         jnative.build_encode_tables(nt, L)):
        assert got.dtype == want.dtype and (got == want).all()
    got, want = native.build_decode_tables(nt, L), \
        jnative.build_decode_tables(nt, L)
    assert got.dtype == want.dtype and (got == want).all()


@pytest.mark.parametrize("pack_bits", [False, True])
@pytest.mark.parametrize("k", [128, 384])
def test_lane_repack_equal_jax(pack_bits, k):
    rng = np.random.default_rng(k + pack_bits)
    B, W = 5, 24
    sizes = rng.integers(0, 32 * (W - 2), (B, k)).astype(np.int32)
    sizes[0, :7] = 0
    words = rng.integers(0, 1 << 32, (B, W, k), dtype=np.uint64).astype(
        np.uint32)
    # bits past each lane's size are zero, as the encoder leaves them
    bit = np.arange(W)[None, :, None] * 32
    keep = np.clip(sizes[:, None, :] - bit, 0, 32)
    words &= ((np.uint64(1) << keep.astype(np.uint64)) - 1).astype(np.uint32)
    payloads = native.lane_merge_batch(words, sizes, pack_bits)
    assert payloads == jnative.lane_merge_batch(words, sizes, pack_bits)
    back = native.lane_split_batch(payloads, sizes, k, W, pack_bits)
    assert (back == jnative.lane_split_batch(payloads, sizes, k, W,
                                             pack_bits)).all()
    assert (back == words).all()
    with pytest.raises(ValueError):
        native.lane_split_batch([p[:-1] for p in payloads], sizes, k, W,
                                pack_bits)


@pytest.mark.parametrize("k", [128, 1024, 16384])
def test_size_table_codec_equal_jax(k):
    """The FLAG_PACKED lane-size table: 2k bytes of LE u16 bit counts
    through the k=2 reference-format codec."""
    rng = np.random.default_rng(k)
    st = (rng.normal(40 * 8, 9, k).clip(0, 65535).astype("<u2")).tobytes()
    cs = native.compress(st, k=2)
    assert cs == jnative.compress(st, k=2)
    assert native.decompress(cs, k=2, max_out=2 * k + 8) == st
    assert jnative.decompress(cs, k=2, max_out=2 * k + 8) == st
    for tl in (9, 11):
        assert native.compress(st, k=2, table_log=tl) == jnative.compress(
            st, k=2, table_log=tl)
    with pytest.raises(ValueError):
        native.compress(b"\x07" * 64, k=2)  # one symbol: no FSE table


def _port_sources():
    return sorted((ROOT / "entropy_coders_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


# the JAX package, jax itself, and the root scripts that import them (the
# port's tools keep their own copies of what they need from those)
_FORBIDDEN = {"entropy_coders_tpu", "jax", "bench", "bench_configs",
              "policy_sweep"}


def _imports_jax_package(tree) -> list:
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in _FORBIDDEN]
    return bad


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_never_imports_jax_package(path):
    assert _imports_jax_package(ast.parse(path.read_text())) == []


def test_source_scan_finds_an_import():
    """The scan above sees every form it looks for."""
    src = ("import entropy_coders_tpu\nfrom entropy_coders_tpu.spec import x\n"
           "import entropy_coders_tpu_torch\nfrom . import native\n"
           "importlib.import_module('entropy_coders_tpu.native')\n"
           "import jax.numpy\nfrom bench_configs import corpus\n"
           "from .bench_configs import corpus\nimport policy_sweep, bench\n")
    assert sorted(n for _, n in _imports_jax_package(ast.parse(src))) == [
        "bench", "bench_configs", "entropy_coders_tpu",
        "entropy_coders_tpu.native", "entropy_coders_tpu.spec", "jax.numpy",
        "policy_sweep"]

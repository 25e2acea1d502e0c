"""The port's decode table-layout harness (entropy_coders_tpu_torch.tools)
against the JAX package's.

``decode_lanes_layout`` runs its plain PyTorch version on CPU tensors; it is
held exactly against the JAX B5 kernel itself (``tools/l10_attack_harness.py``
loaded by path, its ``call_with`` run under ``force_tpu_interpret_mode``) on
lane words from the JAX ``frame.compress(..., lanes=True)``, with the JAX
gather rows and each layout's JAX ``entry_fn``. B4
(``tools/l10_attack.py``) has the same kernel body, checked as text here;
that module compresses 128 MiB when imported, so it is never imported. The
CUDA kernel is held against the plain version on the card by chip_smoke.py.
Tolerance: exact everywhere (integer codec).

Small shapes: B = 2 blocks, k = 256 lanes, R in {31, 33} rounds, so that the
JAX kernel's epoch of E = 3 rounds (L <= 10) divides R or not."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from entropy_coders_tpu import frame as F  # noqa: E402
from entropy_coders_tpu.normalize import normalize_batch  # noqa: E402
from entropy_coders_tpu.ops import pl_coder as JPL  # noqa: E402
from entropy_coders_tpu.spec.fse import DecodeTable  # noqa: E402
from entropy_coders_tpu.spec.histogram import NormHistogram  # noqa: E402
import entropy_coders_tpu_torch as T  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import as_int64, to_device  # noqa: E402
from entropy_coders_tpu_torch.tools import bench_data  # noqa: E402
from entropy_coders_tpu_torch.tools import l10_attack  # noqa: E402
from entropy_coders_tpu_torch.tools import l10_attack_harness as H  # noqa: E402
from entropy_coders_tpu_torch.tools import upack_hilog, upack_l10  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
K = 256
B = 2


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_b5():
    """The JAX package's B5 harness (tools/l10_attack_harness.py)."""
    return _load("jax_l10_attack_harness", ROOT / "tools" / "l10_attack_harness.py")


@pytest.fixture(scope="module")
def bench():
    """The JAX package's bench.py, loaded without enabling jax's persistent
    compilation cache (it does so at import unless told not to)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ECT_PERSISTENT_CACHE", "0")
        return _load("jax_bench", ROOT / "bench.py")


# --- each layout's JAX entry_fn (tbl, states, S, L) -> (nb, base, sym) ------

_gather, _shr = JPL._gather_rows, JPL._shr_u


def entry_flat(tbl, states, S, L):
    # ops/pl_coder.py:329-330 (_decode_kernel's one-entry-per-word path)
    pk = _gather(tbl, states, tbl.shape[0], S)
    return _shr(pk, 16) & 0xFF, pk & 0xFFFF, _shr(pk, 24) & 0xFF


def entry_split(tbl, states, S, L):
    # ops/pl_coder.py:318-328: (nb<<12|base) u16 pairs, then sym quads
    h2 = max((1 << L) // 256, 1)
    h4 = max((1 << L) // 512, 1)
    vp = _gather(tbl[:h2], _shr(states, 1), h2, S)
    half = jnp.where((states & 1) == 1, _shr(vp, 16), vp & 0xFFFF)
    vq = _gather(tbl[h2:], _shr(states, 2), h4, S)
    sym = _shr(vq, lax.shift_left(states & 3, 3)) & 0xFF
    return _shr(half, 12), half & 0xFFF, sym


def entry_upack(tbl, states, S, L):
    # ops/pl_coder.py:306-317: sym(7b)|u(9b) u16 pairs, ilog2 via the f32
    # exponent
    hu = max((1 << L) // 256, 1)
    v = _gather(tbl, _shr(states, 1), hu, S)
    half = jnp.where((states & 1) == 1, _shr(v, 16), v & 0xFFFF)
    u = half & 0x1FF
    e = _shr(lax.bitcast_convert_type(u.astype(jnp.float32), jnp.int32),
             23) - 127
    nb = L - e
    return nb, lax.shift_left(u, nb) - (1 << L), _shr(half, 9)


def entry_nosym(tbl, states, S, L):
    # tools/l10_attack.py:221-227: pair gathers only, junk symbol
    h2 = max((1 << L) // 256, 1)
    vp = _gather(tbl[:h2], _shr(states, 1), h2, S)
    half = jnp.where((states & 1) == 1, _shr(vp, 16), vp & 0xFFFF)
    return _shr(half, 12), half & 0xFFF, half & 0xFF


def entry_fused(tbl, states, S, L):
    # tools/l10_attack.py:242-248: sym<<(L+4)|nb<<L|base, one plane
    hn = max((1 << L) // 128, 1)
    v = _gather(tbl, states, hn, S)
    return _shr(v, L) & 0xF, v & ((1 << L) - 1), _shr(v, L + 4) & 0xFF


ENTRY = {"flat": entry_flat, "split": entry_split, "upack": entry_upack,
         "nosym": entry_nosym, "fused": entry_fused}


def jax_rows(layout, packs, L):
    """(B, rows, 128) int32 gather rows of ``layout`` from the packed
    decode tables, as the JAX tools build them."""
    pk = np.stack(packs).astype(np.int64)
    if layout == "flat":
        return JPL._rows_np(pk)
    if layout == "fused":  # tools/l10_attack.py:234-240
        fused = ((pk >> 24) << (L + 4)) | (((pk >> 16) & 0xFF) << L) | (pk & 0xFFFF)
        return JPL._rows_np(fused)
    rows = np.stack([JPL.decode_table_rows(p, L, layout == "upack")
                     for p in packs])
    # nosym keeps the split layout's pair rows (tools/l10_attack.py:229)
    return rows[:, : max((1 << L) // 256, 1)] if layout == "nosym" else rows


# --- inputs: lanes of JAX frames ---------------------------------------------


def corpus(name, size):
    if name == "bench":  # gen_sequence(0.2), seed 0xF5E
        return bench_data.gen_sequence(0.2, size)
    return upack_hilog.corpus(size)  # 40 symbols, seed 0xA11


@pytest.fixture(scope="module")
def lanes():
    """get(corpus, L, R) -> dict of a 2-block JAX frame's lane words: one
    interpret-mode compress per (corpus, L, R), shared by the cases."""
    cache = {}

    def get(name, L, R):
        if (name, L, R) not in cache:
            bs = (R + 1) * K
            data = corpus(name, B * bs)
            frame = F.compress(data, block_size=bs, k=K, lanes=True,
                               table_log=L, interpret=True)
            sizes, payloads, nt, L2, _ = bench_data.parse_pl_frame(frame, bs, K)
            assert L2 == L
            W = -(-(int(sizes.max()) // 32 + 3) // 16) * 16
            words = JPL.lane_split_batch(payloads, sizes, K, W)
            packs = [DecodeTable(NormHistogram(nt[j], L, F._tl(nt[j]))).packed
                     for j in range(B)]
            cache[name, L, R] = dict(data=data, words=words, sizes=sizes,
                                     nt=nt, packs=packs, W=W)
        return cache[name, L, R]

    return get


def port_inputs(c, L):
    return (to_device(c["words"], "cpu"), torch.from_numpy(c["sizes"]),
            PL.tables_from_norm(c["nt"], L, "cpu").dec)


# (layout, L, R, corpus): upack above L=10 needs the 40-symbol corpus (the
# bench corpus's max count exceeds 256 there); at L=13 with R=31 its 8 KiB
# blocks reach 253 <= 256
CASES = [
    ("split", 8, 31, "bench"),
    ("split", 10, 33, "bench"),
    ("split", 11, 31, "bench"),
    ("upack", 10, 31, "bench"),
    ("upack", 11, 33, "hilog"),
    ("upack", 13, 31, "hilog"),
    ("fused", 10, 33, "bench"),
    ("nosym", 10, 31, "bench"),
    ("flat", 10, 33, "bench"),
    ("flat", 13, 31, "hilog"),
]


@pytest.mark.parametrize("layout,L,R,name", CASES,
                         ids=[f"{c[0]}-L{c[1]}-R{c[2]}-{c[3]}" for c in CASES])
def test_layout_matches_jax_b5(layout, L, R, name, lanes, jax_b5):
    c = lanes(name, L, R)
    words, sizes, dec = port_inputs(c, L)
    syms, finals, cur = H.decode_lanes_layout(
        words, sizes, H.layout_tables(dec, L, layout), layout=layout, L=L, R=R)

    S = K // 128
    rows = jax_rows(layout, c["packs"], L)
    a_words = jnp.asarray(np.ascontiguousarray(c["words"]).view(np.int32)
                          .reshape(B, c["W"], S, 128))
    a_sizes = jnp.asarray(c["sizes"].reshape(B, S, 128))
    with pltpu.force_tpu_interpret_mode():
        js, jf, je = jax_b5.call_with(ENTRY[layout],
                                      jnp.asarray(rows[:, :, None, :]),
                                      a_words, a_sizes, S=S, W=c["W"], L=L,
                                      R=R, B=B)()
    js = np.asarray(js)[:, :R].reshape(B, R, K)
    assert (syms.numpy() == js).all()
    assert (finals.numpy() == np.asarray(jf).reshape(B, K)).all()
    assert (cur.abs().sum(1).numpy() == np.asarray(je).reshape(B)).all()
    if layout != "nosym":  # nosym's bytes are wrong by design
        got = np.concatenate([syms.numpy().reshape(B, -1), finals.numpy()], 1)
        assert (got == c["data"].reshape(B, -1)).all()
        assert not cur.any()


def test_gates_refuse_as_jax(lanes):
    # the bench corpus at L=11 has a count > 256: JAX's upack_ok refuses
    c = lanes("bench", 11, 31)
    assert not JPL.upack_ok(c["nt"], 11) and not H.upack_ok(c["nt"], 11)
    _, _, dec = port_inputs(c, 11)
    with pytest.raises(ValueError, match="upack does not apply"):
        H.layout_tables(dec, 11, "upack")
    # the JAX split rows exist only up to L = 12 (pl_coder.py:600-601)
    c13 = lanes("hilog", 13, 31)
    words, sizes, dec13 = port_inputs(c13, 13)
    for layout in ("split", "nosym"):
        with pytest.raises(ValueError, match="table logs 5..12"):
            H.layout_tables(dec13, 13, layout)
        with pytest.raises(ValueError, match="table logs 5..12"):
            H.decode_lanes_layout(words, sizes, (dec13,), layout=layout,
                                  L=13, R=31)
    with pytest.raises(ValueError, match="unknown layout"):
        H.layout_tables(dec13, 13, "quad")


@pytest.mark.parametrize("L", [8, 9, 10, 11, 12, 13])
@pytest.mark.parametrize("name", ["bench", "hilog"])
def test_upack_ok_matches_jax(name, L):
    blocks = corpus(name, 3 * 8192).reshape(3, 8192)
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks])
    nt, l2 = normalize_batch(counts, 8192, L)
    assert (l2 == L).all()
    assert H.upack_ok(nt, L) == JPL.upack_ok(nt, L)
    dec = PL.tables_from_norm(nt, L, "cpu").dec
    packs = [DecodeTable(NormHistogram(nt[j], L, F._tl(nt[j]))).packed
             for j in range(3)]
    assert JPL.upack_ok_packed(packs, L) == JPL.upack_ok(nt, L)
    if JPL.upack_ok(nt, L):
        H.layout_tables(dec, L, "upack")
    else:
        with pytest.raises(ValueError):
            H.layout_tables(dec, L, "upack")


@pytest.mark.parametrize("layout", H.LAYOUTS)
def test_layout_tables_round_trip(layout):
    # L=10 on the bench corpus: every layout applies
    L = 10
    blocks = corpus("bench", 2 * 8192).reshape(2, 8192)
    nt, _ = normalize_batch(np.stack([np.bincount(b, minlength=256)
                                      for b in blocks]), 8192, L)
    dec = PL.tables_from_norm(nt, L, "cpu").dec
    table = H.layout_tables(dec, L, layout)
    assert sum(p.element_size() for p in table) == H.table_bytes(layout, L) >> L
    assert all(p.shape == dec.shape and p.is_contiguous() for p in table)
    e = as_int64(dec)
    states = torch.arange(1 << L).repeat(2, 1)
    nb, base, sym = H._entries(layout, table, L)(states)
    assert torch.equal(nb, (e >> 16) & 0xFF)
    assert torch.equal(base, e & 0xFFFF)
    assert torch.equal(sym, (e & 0xFF) if layout == "nosym" else e >> 24)


@pytest.mark.parametrize("bit_pack", [False, True])
def test_parse_pl_frame_matches_bench(bit_pack, bench):
    bs, k = 8192, 256
    data = bench_data.gen_sequence(0.2, 3 * bs, 7)
    frame = T.compress(data, block_size=bs, k=k, lanes=True, table_log=10,
                       bit_pack=bit_pack, device="cpu")
    got = bench_data.parse_pl_frame(frame, bs, k)
    want = bench._parse_pl_frame(frame, bs, k)
    assert (got[0] == want[0]).all() and got[1] == want[1]
    assert (got[2] == want[2]).all() and got[3:] == want[3:] == (10, bit_pack)
    words = PL.lane_split_batch(got[1], got[0], k, 64, pack_bits=bit_pack)
    syms, finals = PL.decode_lanes_norm(to_device(words, "cpu"),
                                        torch.from_numpy(got[0]), got[2], k=k,
                                        L=10, R=bs // k - 1)
    out = np.concatenate([syms.numpy().reshape(3, -1), finals.numpy()], 1)
    assert (out == data.reshape(3, -1)).all()


@pytest.mark.parametrize("prob,size,seed", [(0.2, 100_003, 0xF5E),
                                            (0.01, 4096, 3), (0.9, 77, 1)])
def test_gen_sequence_matches_bench(prob, size, seed, bench):
    assert (bench_data.gen_sequence(prob, size, seed)
            == bench.gen_sequence(prob, size, seed)).all()


def _kern_body(path):
    lines = path.read_text().splitlines()
    start = next(i for i, s in enumerate(lines) if s.startswith("    def kern("))
    end = next(i for i in range(start, len(lines)) if lines[i] == "    return kern")
    return lines[start: end + 1]


def test_b4_and_b5_kernel_bodies_are_one_text():
    b4 = _kern_body(ROOT / "tools" / "l10_attack.py")
    b5 = _kern_body(ROOT / "tools" / "l10_attack_harness.py")
    assert len(b4) == 82 and b4 == b5


@pytest.mark.parametrize("tool,L", [(l10_attack, 10), (upack_l10, 10),
                                    (upack_hilog, 13)])
def test_tools_run_on_cpu(tool, L, capsys):
    res = tool.run(L, 2 * 8192, "cpu", block_size=8192, k=K)
    want = {l10_attack: set(H.LAYOUTS), upack_l10: {"split", "upack"},
            upack_hilog: {"flat", "upack"}}[tool]
    assert set(res) == want | {"base"}
    assert all(r["eligible"] and "ms" not in r for r in res.values())
    assert "not timed" in capsys.readouterr().out


def test_corrupt_lane_leaves_a_cursor(lanes):
    c = lanes("bench", 10, 31)
    words, sizes, dec = port_inputs(c, 10)
    bad = sizes.clone()
    bad[0, 3] ^= 0x4000
    for layout in H.LAYOUTS:
        _, _, cur = H.decode_lanes_layout(
            words, bad, H.layout_tables(dec, 10, layout), layout=layout, L=10,
            R=31)
        assert int(cur[0, 3]) != 0 and not cur[1].any()


def test_wrapper_checks_inputs_and_cpu_launches_no_kernel(lanes):
    before = dict(H.LAYOUT_LAUNCHES)
    c = lanes("bench", 10, 31)
    words, sizes, dec = port_inputs(c, 10)
    split = H.layout_tables(dec, 10, "split")
    kw = dict(layout="split", L=10, R=31)
    with pytest.raises(ValueError, match="2 plane"):
        H.decode_lanes_layout(words, sizes, split[:1], **kw)
    with pytest.raises(ValueError, match="dtype"):
        H.decode_lanes_layout(words, sizes, (split[0], split[1].to(torch.int16)),
                              **kw)
    with pytest.raises(ValueError, match="shape"):
        H.decode_lanes_layout(words, sizes[:1], split, **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        H.decode_lanes_layout(words[:, :, :100].contiguous(), sizes, split,
                              **kw)
    with pytest.raises(ValueError, match="table logs"):
        H.decode_lanes_layout(words, sizes, split, layout="fused", L=16, R=31)
    H.decode_lanes_layout(words, sizes, split, **kw)
    assert H.LAYOUT_LAUNCHES == before == dict.fromkeys(H.LAYOUTS, 0)

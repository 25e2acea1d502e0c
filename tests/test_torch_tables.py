"""The port's device-side table build (entropy_coders_tpu_torch.ops.tables)
against the JAX package's (entropy_coders_tpu.ops.tables, run on the CPU as
tests/test_ops_tables.py runs it), the spec oracle and the port's C++ host
library, on the CPU (the plain PyTorch versions; the CUDA kernel D3 runs
only on the card, where chip_smoke.py holds it against them).

Tolerance: exact. Inputs come from a numpy seed; every table array is
compared element for element."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu.ops import tables as JT  # noqa: E402
from entropy_coders_tpu.ops import pl_coder as JPL  # noqa: E402
from entropy_coders_tpu.spec.fse import DecodeTable, EncodeTable  # noqa: E402
from entropy_coders_tpu.spec.histogram import NormHistogram  # noqa: E402
from entropy_coders_tpu_torch import native  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.ops import tables as TB  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import to_numpy  # noqa: E402

LOGS = list(range(5, 16))


def norm_tables(seed: int, B: int, L: int) -> np.ndarray:
    """(B, 256) int32 normalized counts at table log L: geometric data of
    differing skew, so that low-probability (-1) symbols occur, and an
    alphabet that ends below 255 (transforms past table_len stay 0)."""
    rng = np.random.default_rng(seed)
    top = min(255, (1 << (L - 1)) - 2)
    rows = []
    for i in range(B):
        data = (rng.geometric(0.03 + 0.9 * (i % 5) / 5, 1 << 14) - 1).clip(
            0, top if i % 2 else top // 2)
        nt, l2 = native.normalize(np.bincount(data, minlength=256),
                                  len(data), L)
        assert l2 == L
        rows.append(nt)
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("L", LOGS)
def test_spread_equal_jax(L):
    nt = norm_tables(L, 3, L)
    syms, ht = TB.spread_symbols_dev(torch.from_numpy(nt), log2=L)
    assert syms.dtype == torch.int32 and syms.shape == (3, 1 << L)
    for b in range(3):
        jsyms, jht = JT.spread_symbols_dev(nt[b], log2=L)
        assert int(ht[b]) == int(jht)
        assert (syms[b].numpy() == np.asarray(jsyms)).all()
        # one (256,) table in, one table out: the JAX signature
        one, one_ht = TB.spread_symbols_dev(torch.from_numpy(nt[b]), log2=L)
        assert torch.equal(one, syms[b]) and int(one_ht) == int(jht)


@pytest.mark.parametrize("L", LOGS)
def test_encode_table_equal_jax_and_native(L):
    nt = norm_tables(100 + L, 4, L)
    table, tt_bits, tt_fs = TB.build_encode_table(torch.from_numpy(nt), log2=L)
    assert (table.dtype, tt_bits.dtype, tt_fs.dtype) == (
        torch.uint16, torch.uint32, torch.int32)
    ntable, nbits, nfs = native.build_encode_tables(nt, L)
    assert (to_numpy(table) == ntable).all()
    assert (to_numpy(tt_bits) == nbits).all()
    assert (tt_fs.numpy() == nfs).all()
    for b in range(4):
        jt, jb, jf = JT.build_encode_table(nt[b], log2=L)
        assert (to_numpy(table[b]) == np.asarray(jt)).all()
        assert (to_numpy(tt_bits[b]) == np.asarray(jb)).all()
        assert (tt_fs[b].numpy() == np.asarray(jf)).all()


@pytest.mark.parametrize("L", LOGS)
def test_decode_table_equal_jax_and_native(L):
    nt = norm_tables(200 + L, 4, L)
    packed = TB.build_decode_table(torch.from_numpy(nt), log2=L)
    assert packed.dtype == torch.uint32
    assert (to_numpy(packed) == native.build_decode_tables(nt, L)).all()
    for b in range(4):
        jp = JT.build_decode_table(nt[b], log2=L)
        assert (to_numpy(packed[b]) == np.asarray(jp)).all()


@pytest.mark.parametrize("L", [5, 9, 12, 15])
def test_tables_equal_spec(L):
    nt = norm_tables(300 + L, 2, L)
    dec, tt_bits, tt_fs, next_state = TB.build_tables(torch.from_numpy(nt), L)
    for b in range(2):
        norm = NormHistogram.try_from(nt[b])
        assert norm.log2 == L
        enc, d = EncodeTable(norm), DecodeTable(norm)
        assert (to_numpy(next_state[b]) == enc.table).all()
        assert (to_numpy(tt_bits[b]) == enc.tt_bits).all()
        assert (tt_fs[b].numpy() == enc.tt_find_state).all()
        assert (to_numpy(dec[b]) == d.packed).all()


def test_low_symbols_and_table_len():
    """Counts of -1 take the table's top slots in symbol order, and the
    transforms of symbols at and past table_len stay 0."""
    L = 8
    nt = np.zeros((1, 256), np.int32)
    nt[0, [3, 9, 40]] = -1
    nt[0, 5] = 200
    nt[0, 17] = 53
    assert int(np.where(nt == -1, 1, nt).sum()) == 1 << L
    syms, ht = TB.spread_symbols_dev(torch.from_numpy(nt), log2=L)
    assert int(ht[0]) == 255 - 3
    assert syms[0, -3:].tolist() == [40, 9, 3]
    dec, tt_bits, tt_fs, next_state = TB.build_tables(torch.from_numpy(nt), L)
    assert not to_numpy(tt_bits)[0, 41:].any() and not tt_fs[0, 41:].any()
    assert to_numpy(tt_bits)[0, 0] == ((L + 1) << 16) - (1 << L)  # count 0
    ntable, nbits, nfs = native.build_encode_tables(nt, L)
    assert (to_numpy(next_state) == ntable).all()
    assert (to_numpy(tt_bits) == nbits).all() and (tt_fs.numpy() == nfs).all()
    assert (to_numpy(dec) == native.build_decode_tables(nt, L)).all()


def test_shared_table_rows_equal():
    """B equal rows (the shared-table case) give B equal tables."""
    nt = np.repeat(norm_tables(7, 1, 10), 5, 0)
    for t in TB.build_tables(torch.from_numpy(nt), 10):
        assert all(torch.equal(t[0].view(torch.uint8), t[b].view(torch.uint8))
                   for b in range(5))


@pytest.mark.parametrize("L", LOGS)
def test_tables_from_norm_routes_equal(L):
    """``host_tables=True`` (the C++ build), ``False`` (ops.tables) and
    ``None`` (the C++ build on the CPU) fill the same LaneTables."""
    nt = norm_tables(400 + L, 3, L)
    host = PL.tables_from_norm(nt, L, "cpu", host_tables=True)
    dev = PL.tables_from_norm(nt, L, "cpu", host_tables=False)
    auto = PL.tables_from_norm(nt, L, "cpu")
    for h, d, a in zip(host, dev, auto):
        assert h.dtype == d.dtype and h.shape == d.shape
        assert torch.equal(h.view(torch.uint8), d.view(torch.uint8))
        assert torch.equal(h.view(torch.uint8), a.view(torch.uint8))


def test_cpu_tensors_launch_no_kernel():
    before = TB.TABLE_LAUNCHES
    TB.build_tables(torch.from_numpy(norm_tables(1, 2, 9)), 9)
    PL.tables_from_norm(norm_tables(1, 2, 9), 9, "cpu", host_tables=False)
    assert TB.TABLE_LAUNCHES == before


@pytest.mark.parametrize("route", [True, False])
def test_malformed_tables_raise_value_error(route):
    nt = norm_tables(2, 2, 9)
    for bad in ("sum", "range", "log", "single"):
        t = nt.copy()
        L = 9
        if bad == "sum":
            t[1, 0] += 1
        elif bad == "range":
            t[1, 0] = -2
        elif bad == "log":
            L = 16
        else:
            t[1] = 0
            t[1, 0] = 512
        with pytest.raises(ValueError):
            PL.tables_from_norm(t, L, "cpu", host_tables=route)


def test_build_tables_checks_inputs():
    nt = torch.from_numpy(norm_tables(3, 2, 9))
    with pytest.raises(ValueError):
        TB.build_tables(nt, 4)
    with pytest.raises(ValueError):
        TB.build_tables(nt.to(torch.int64), 9)
    with pytest.raises(ValueError):
        TB.build_tables(nt[:, :100], 9)
    with pytest.raises(ValueError):
        TB.build_tables(nt[0], 9)


def _blocks(seed, B, k, Q):
    rng = np.random.default_rng(seed)
    return (rng.geometric(0.2, (B, Q * k)) - 1).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("L", [8, 11])
def test_lane_entries_host_tables_routes_equal(L):
    """``encode_lanes_norm``/``decode_lanes_norm`` with ``host_tables=True``
    and ``False``: identical words, sizes and decoded bytes, as
    tests/test_pl_coder.py pins it for the JAX package; and the JAX
    package's ``host_tables=False`` route (interpret mode) gives the same
    sizes and lane bytes."""
    from entropy_coders_tpu_torch.normalize import normalize_batch

    B, k, Q = 2, 128, 9
    blocks = _blocks(L, B, k, Q)
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks])
    nt, l2 = normalize_batch(counts, Q * k, L)
    assert (l2 == L).all()
    R, W = Q - 1, PL.encode_w_bound(Q - 1, L)
    out = {}
    for ht in (True, False):
        words, sizes = PL.encode_lanes_norm(torch.from_numpy(blocks), nt, k=k,
                                            L=L, W=W, host_tables=ht)
        syms, finals = PL.decode_lanes_norm(words.contiguous(), sizes, nt,
                                            k=k, L=L, R=R, host_tables=ht)
        got = torch.cat([syms.reshape(B, -1), finals], 1).numpy()
        assert (got == blocks).all()
        out[ht] = (to_numpy(words), sizes.numpy())
    assert (out[True][0] == out[False][0]).all()
    assert (out[True][1] == out[False][1]).all()
    jw, js = JPL.encode_lanes_norm(blocks, nt, k=k, L=L, W=W, interpret=True,
                                   host_tables=False)
    assert (np.asarray(js) == out[False][1]).all()
    for b in range(B):
        assert JPL.lane_merge(np.asarray(jw)[b], np.asarray(js)[b]) == \
            PL.lane_merge(out[False][0][b], out[False][1][b])


# --- the half a caller reads, and one build a lane group ---------------------

HALF_FIELDS = {"decode": ("dec",), "encode": ("tt_bits", "tt_fs", "next_state"),
               "both": ("dec", "tt_bits", "tt_fs", "next_state")}


@pytest.mark.parametrize("route", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("half", list(HALF_FIELDS))
@pytest.mark.parametrize("L", [5, 10, 15])
def test_tables_from_norm_builds_only_its_half(L, half, route, monkeypatch):
    """``half`` fills only the fields its caller reads, equal to the whole
    build's, on both routes; the host route runs only that half's C++ build
    and the device route asks ``build_tables`` for that half only."""
    nt = norm_tables(500 + L, 3, L)
    whole = PL.tables_from_norm(nt, L, "cpu", host_tables=route)
    calls = []
    for mod, name in ((native, "build_encode_tables"),
                      (native, "build_decode_tables"),
                      (TB, "build_tables")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **kw: (
            calls.append((_n, kw.get("half", a[2] if len(a) > 2 else None)))
            or _r(*a, **kw)))
    got = PL.tables_from_norm(nt, L, "cpu", host_tables=route, half=half)
    for name in PL.LaneTables._fields:
        g = getattr(got, name)
        if name in HALF_FIELDS[half]:
            w = getattr(whole, name)
            assert g.dtype == w.dtype
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
        else:
            assert g is None, name
    if route:
        want = {"decode": [("build_decode_tables", None)],
                "encode": [("build_encode_tables", None)],
                "both": [("build_encode_tables", None),
                         ("build_decode_tables", None)]}[half]
        assert calls == want
    else:
        assert calls == [("build_tables", half)]


@pytest.mark.parametrize("half", list(HALF_FIELDS))
def test_build_tables_ref_half(half):
    nt = torch.from_numpy(norm_tables(600, 2, 11))
    whole = TB.build_tables_ref(nt, 11)
    got = TB.build_tables_ref(nt, 11, half)
    for name, g, w in zip(PL.LaneTables._fields, got, whole):
        if name in HALF_FIELDS[half]:
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
        else:
            assert g is None


@pytest.mark.parametrize("route", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("half", list(HALF_FIELDS))
def test_no_blocks_and_malformed_by_half(half, route):
    """B == 0 gives empty arrays of the half's fields; a malformed table
    raises ValueError whichever half is asked for, on either route."""
    got = PL.tables_from_norm(np.zeros((0, 256), np.int32), 9, "cpu",
                              host_tables=route, half=half)
    for name in PL.LaneTables._fields:
        t = getattr(got, name)
        if name in HALF_FIELDS[half]:
            assert t.shape[0] == 0
        else:
            assert t is None
    nt = norm_tables(2, 2, 9)
    nt[1, 0] += 1
    with pytest.raises(ValueError):
        PL.tables_from_norm(nt, 9, "cpu", host_tables=route, half=half)
    with pytest.raises(ValueError):
        PL.tables_from_norm(norm_tables(2, 2, 9), 9, "cpu", host_tables=route,
                            half="neither")


def test_build_tables_checks_half_and_cluster():
    nt = torch.from_numpy(norm_tables(3, 2, 9))
    with pytest.raises(ValueError):
        TB.build_tables(nt, 9, "dec")
    for bad in (3, 16, 0):
        with pytest.raises(ValueError):
            TB.build_tables(nt, 9, "both", cluster=bad)
    with pytest.raises(ValueError):  # fewer than 32 slots a CTA
        TB.build_tables(torch.from_numpy(norm_tables(3, 2, 5)), 5, cluster=2)


@pytest.fixture(scope="module")
def grouped_frame():
    """Data whose blocks fall into two table-log groups of several blocks,
    and the JAX package's frame of it (Pallas in interpret mode)."""
    from entropy_coders_tpu import frame as JF
    from tests.conftest import gen_sequence

    data = np.concatenate([gen_sequence(0.1, 5 * 4096, seed=3),
                           gen_sequence(0.4, 4 * 4096, seed=4)])
    kw = dict(block_size=4096, k=128, lanes=True)
    return data, kw, JF.compress(data, lanes=True, interpret=True,
                                 block_size=4096, k=128)


@pytest.mark.parametrize("route", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("repack", [False, True], ids=["cpp", "device"])
def test_lane_group_builds_its_tables_once(grouped_frame, repack, route,
                                           monkeypatch):
    """With 2-block chunks each lane group spans several chunks, yet its
    tables are built once a direction, encode only the encode half and
    decode only ``dec``, on either table route (``host_tables``, forced
    here: on the CPU the container takes the C++ build); every chunk's
    kernel call gets its rows of them (views, no build of its own); the
    frame is the JAX package's."""
    from entropy_coders_tpu_torch import frame as F

    data, kw, jax_frame = grouped_frame
    monkeypatch.setattr(F, "_CHUNK_RAW", 2 * 4096)
    monkeypatch.setattr(F, "_DEVICE_REPACK", repack)
    builds = []
    real = PL.tables_from_norm

    def counted(norm_tables, L, device, host_tables=None, half="both"):
        builds.append((half, len(norm_tables), int(L)))
        return real(norm_tables, L, device, route, half)

    monkeypatch.setattr(PL, "tables_from_norm", counted)
    frame = F.compress(data, device="cpu", **kw)
    assert frame == jax_frame
    pf = F._parse_frame(frame)
    groups = {}
    for i in range(pf.n_blocks):
        if pf.modes[i] == F.MODE_FSE_PL:
            l2 = F._read_block_header(pf.section(i))[1]
            groups[l2] = groups.get(l2, 0) + 1
    assert len(groups) >= 2 and max(groups.values()) >= 3
    assert sorted(builds) == sorted(("encode", n, l2)
                                    for l2, n in groups.items())
    builds.clear()
    assert F.decompress(frame, device="cpu") == data.tobytes()
    assert sorted(builds) == sorted(("decode", n, l2)
                                    for l2, n in groups.items())

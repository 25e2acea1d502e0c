"""The port's public lane entries (``entropy_coders_tpu_torch.ops``
``decode_lanes``, ``encode_lanes``, ``encode_w_bound`` and
``ops.histogram.histogram_u8``) against the JAX package's, whose Pallas
kernels run in interpret mode as ``tests/test_pl_coder.py`` runs them, and
against ``spec``.

The entries take the JAX signatures (less the TPU knobs ``interpret``,
``mesh``, ``e_rounds`` and ``small_alpha``). On the CPU they run the plain
versions of B1 and B2, so these tests hold the entries' own work (the
table stacking, the block the encode reads, the JAX trim of the words, the
cursor check) byte-exact against the JAX package; the kernels are held
against the plain versions on the card by ``chip_smoke.py`` (phase
``lane_entries``). Tolerance: exact everywhere (an integer codec).

Each JAX interpret call is a fresh trace, seconds each (~18 s for the L=15
decode), so a module-scoped fixture runs each case's JAX encode and decode
once."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu.ops import pl_coder as JPL  # noqa: E402
from entropy_coders_tpu.ops.histogram import histogram_u8 as jax_histogram_u8  # noqa: E402
from entropy_coders_tpu.spec.bitstream import BitStackWriter  # noqa: E402
from entropy_coders_tpu.spec.fse import DecodeTable, EncodeTable, Encoder  # noqa: E402
from entropy_coders_tpu.spec.histogram import Histogram, NormHistogram  # noqa: E402
from entropy_coders_tpu_torch import ops  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.ops.histogram import histogram_u8  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import (  # noqa: E402
    entry_device, entry_tensor, to_device, to_numpy)


def geo(rng, n):
    return (rng.integers(0, 40, n, dtype=np.uint16) ** 2 % 251).astype(np.uint8)


def narrow(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def tiny(rng, n):
    return rng.integers(0, 3, n).astype(np.uint8)


def full(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8)


def geometric(rng, n):
    return (rng.geometric(0.2, n) - 1).clip(0, 255).astype(np.uint8)


# (name, seed, B, k, Q, generator, table log or None for NormHistogram.new):
# the JAX tests' cases (tests/test_pl_coder.py: geo Q=16 and narrow Q=9 at
# B=2, k=256; L = 5, 6, 8 with a tiny alphabet; L = 13, 15), with their
# seeds, and R = Q - 1 in every class mod 3 (R % 3 == 2 is the JAX
# package's packed-encode gate at its default E = 3; k1024 is the B=1,
# k=1024, Q=18 shape that gate's route had no end-to-end test at)
CASES = [
    ("geo-Q16", 7, 2, 256, 16, geo, None),        # R % 3 == 0
    ("narrow-Q9", 7, 2, 256, 9, narrow, None),    # R % 3 == 2
    ("tiny-L5", 5, 1, 128, 6, tiny, 5),           # R % 3 == 2
    ("tiny-L6", 6, 1, 128, 6, tiny, 6),
    ("tiny-L8", 8, 1, 128, 6, tiny, 8),
    ("full-L13", 13, 1, 128, 5, full, 13),        # R % 3 == 1
    ("full-L15", 15, 1, 128, 5, full, 15),
    ("k1024-Q18", 1, 1, 1024, 18, geometric, None),
    ("geometric-L10-Q8", 10, 2, 128, 8, geometric, 10),  # R % 3 == 1
]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    name, seed, B, k, Q, gen, L = request.param
    rng = np.random.default_rng(seed)
    datas = [gen(rng, k * Q) for _ in range(B)]
    hists = [NormHistogram.new(d) if L is None else Histogram(d).normalize(L)
             for d in datas]
    L = hists[0].log2
    assert all(h.log2 == L for h in hists)
    encs = [EncodeTable(h) for h in hists]
    enc_tables = [(e.table, e.tt_bits, e.tt_find_state) for e in encs]
    packs = np.stack([DecodeTable(h).packed for h in hists])
    R = Q - 1
    blocks = np.stack(datas)
    syms = blocks[:, : R * k].reshape(B, R, k)
    init = blocks[:, R * k:]
    W = JPL.encode_w_bound(R, L)
    jw, js = JPL.encode_lanes(syms, init, enc_tables, k=k, L=L, W=W,
                              interpret=True)
    jw, js = np.asarray(jw), np.asarray(js)
    # the JAX encode's trimmed words, as its decode takes them
    jsyms, jfin = JPL.decode_lanes(jw, js, packs, k=k, L=L, R=R,
                                   interpret=True)
    return dict(name=name, B=B, k=k, L=L, R=R, W=W, blocks=blocks, syms=syms,
                init=init, encs=encs, enc_tables=enc_tables, packs=packs,
                jw=jw, js=js, jsyms=np.asarray(jsyms), jfin=np.asarray(jfin))


def port_encode(c, enc_tables=None, **kw):
    words, sizes = ops.encode_lanes(
        c["syms"], c["init"], c["enc_tables"] if enc_tables is None
        else enc_tables, k=c["k"], L=c["L"], W=c["W"], device="cpu", **kw)
    return to_numpy(words), sizes.numpy()


def port_decode(c, words, sizes, packs=None):
    syms, finals = ops.decode_lanes(
        words, sizes, c["packs"] if packs is None else packs, k=c["k"],
        L=c["L"], R=c["R"], device="cpu")
    return syms.numpy(), finals.numpy()


def spec_lane_stream(seq, enc: EncodeTable):
    """Reference-format single-stream payload of one lane: init folds the
    last byte, the rest codes in reverse, the final state closes it."""
    out = bytearray()
    w = BitStackWriter(out)
    e = Encoder.new_first_symbol(enc, int(seq[-1]))
    for b in seq[-2::-1]:
        e.encode(w, int(b))
    e.finish(w)
    bits = w.finish()  # flushes the last bytes into ``out``
    return bytes(out), bits


# --- against the JAX package (interpret mode) --------------------------------


def test_encode_matches_jax(case):
    c = case
    words, sizes = port_encode(c)
    assert words.dtype == np.uint32 and sizes.dtype == np.int32
    assert words.shape == c["jw"].shape  # w_act included
    assert (words == c["jw"]).all() and (sizes == c["js"]).all()


def test_w_act_matches_jax(case):
    c = case
    words, sizes = port_encode(c)
    w_act = min((int(c["js"].max()) + 31) // 32 + 1, c["W"])
    assert words.shape[1] == c["jw"].shape[1] == w_act


def test_decode_matches_jax(case):
    """The JAX encode's trimmed words (no guard rows; the JAX decode pads
    them to 8 rows, the port reads past them as zero) decode to the JAX
    decode's output and to the input."""
    c = case
    syms, finals = port_decode(c, c["jw"], c["js"])
    assert syms.shape == (c["B"], c["R"], c["k"]) and syms.dtype == np.uint8
    assert (syms == c["jsyms"]).all() and (finals == c["jfin"]).all()
    got = np.concatenate([syms.reshape(c["B"], -1), finals], axis=1)
    assert (got == c["blocks"]).all()


def test_decode_needs_no_guard_rows(case):
    """Words cut to the longest lane's own rows, one short of the JAX
    trim, still decode."""
    c = case
    rows = (int(c["js"].max()) + 31) // 32
    syms, finals = port_decode(c, np.ascontiguousarray(c["jw"][:, :rows]),
                               c["js"])
    assert (syms == c["jsyms"]).all() and (finals == c["jfin"]).all()


def test_stacked_and_listed_tables_agree(case):
    c = case
    stacked = tuple(np.stack(part) for part in zip(*c["enc_tables"]))
    assert all(a.ndim == 2 for a in stacked)
    rows_as_tensors = [tuple(to_device(t, "cpu") for t in row)
                       for row in c["enc_tables"]]
    for tables in (stacked, rows_as_tensors):
        words, sizes = port_encode(c, enc_tables=tables)
        assert (words == c["jw"]).all() and (sizes == c["js"]).all()
    for packs in (list(c["packs"]), c["packs"],
                  [to_device(row, "cpu") for row in c["packs"]]):
        syms, finals = port_decode(c, c["jw"], c["js"], packs=packs)
        assert (syms == c["jsyms"]).all() and (finals == c["jfin"]).all()


def test_lanes_match_spec(case):
    """Every lane's size and bits equal the reference encoder's on that
    lane's strided bytes."""
    c = case
    words, sizes = port_encode(c)
    k = c["k"]
    for b in range(c["B"]):
        payloads, bits = zip(*(spec_lane_stream(c["blocks"][b, i::k],
                                                c["encs"][b])
                               for i in range(k)))
        assert (sizes[b] == np.array(bits)).all()
        assert PL.lane_merge(words[b], sizes[b]) == b"".join(payloads)


# --- contracts ---------------------------------------------------------------


def _small():
    """A B=2, k=128, L=9 input and its JAX-free tables (the port's own)."""
    rng = np.random.default_rng(3)
    blocks = geometric(rng, 2 * 128 * 8).reshape(2, -1)
    hists = [Histogram(b).normalize(9) for b in blocks]
    encs = [EncodeTable(h) for h in hists]
    return dict(B=2, k=128, L=9, R=7, W=PL.encode_w_bound(7, 9),
                blocks=blocks, syms=blocks[:, : 7 * 128].reshape(2, 7, 128),
                init=blocks[:, 7 * 128:],
                enc_tables=[(e.table, e.tt_bits, e.tt_find_state)
                            for e in encs],
                packs=np.stack([DecodeTable(h).packed for h in hists]))


def test_round_trip_with_tensors_and_counts_no_launch():
    """CPU tensor inputs run the plain versions (device=None takes the
    tensors' device) and launch no kernel."""
    c = _small()
    before = (PL.DECODE_LAUNCHES, PL.ENCODE_LAUNCHES, PL.DECODE_BLOCKS)
    words, sizes = ops.encode_lanes(
        torch.from_numpy(c["syms"]), torch.from_numpy(c["init"]),
        c["enc_tables"], k=128, L=9, W=c["W"])
    assert words.device.type == "cpu" and words.is_contiguous()
    syms, finals = ops.decode_lanes(words, sizes, c["packs"], k=128, L=9,
                                    R=7)
    got = torch.cat([syms.reshape(2, -1), finals], 1).numpy()
    assert (got == c["blocks"]).all()
    assert (PL.DECODE_LAUNCHES, PL.ENCODE_LAUNCHES,
            PL.DECODE_BLOCKS) == before == (0, 0, 0)


def test_corrupt_lane_size_raises():
    c = _small()
    words, sizes = ops.encode_lanes(c["syms"], c["init"], c["enc_tables"],
                                    k=128, L=9, W=c["W"], device="cpu")
    bad = sizes.clone()
    bad[0, 3] ^= 0x4000  # past anything 7 rounds can consume
    with pytest.raises(ValueError, match="lane cursor not drained"):
        ops.decode_lanes(words, bad, c["packs"], k=128, L=9, R=7,
                         device="cpu")


def test_numpy_inputs_default_to_cuda(monkeypatch):
    """device=None with numpy inputs means CUDA, which raises where it is
    missing: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = _small()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.encode_lanes(c["syms"], c["init"], c["enc_tables"], k=128, L=9,
                         W=c["W"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.decode_lanes(np.zeros((2, 4, 128), np.uint32),
                         np.zeros((2, 128), np.int32), c["packs"], k=128,
                         L=9, R=7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        histogram_u8(c["blocks"][0])


def test_read_only_numpy_inputs():
    """``np.asarray`` of a JAX array is read-only: the entries take it
    without a warning, and on the CPU a read-only array is copied where a
    writable one is shared."""
    import warnings

    c = _small()
    ro = {n: c[n].copy() for n in ("syms", "init", "packs")}
    for a in ro.values():
        a.setflags(write=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        words, sizes = ops.encode_lanes(ro["syms"], ro["init"],
                                        c["enc_tables"], k=128, L=9,
                                        W=c["W"], device="cpu")
        w, s = to_numpy(words), sizes.numpy()
        w.setflags(write=False)
        s.setflags(write=False)
        syms, finals = ops.decode_lanes(w, s, ro["packs"], k=128, L=9, R=7,
                                        device="cpu")
        init = np.ascontiguousarray(c["init"])
        shared = entry_tensor(init, np.uint8, torch.device("cpu"))
        copied = entry_tensor(ro["init"], np.uint8, torch.device("cpu"))
    got = torch.cat([syms.reshape(2, -1), finals], 1).numpy()
    assert (got == c["blocks"]).all()
    assert shared.data_ptr() == init.ctypes.data
    assert copied.data_ptr() != ro["init"].ctypes.data
    assert torch.equal(copied, shared)


def test_entry_device_rule():
    """device=None takes the tensors' device (they must agree); only CUDA
    and the CPU are taken."""
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    assert entry_device(None, np.zeros(2), [cpu]) == torch.device("cpu")
    assert entry_device("cpu", meta) == torch.device("cpu")
    with pytest.raises(ValueError, match="several devices"):
        entry_device(None, cpu, (np.zeros(2), meta))
    with pytest.raises(ValueError, match="unsupported device"):
        entry_device(None, meta)


@pytest.mark.parametrize("knob,value", [("interpret", True), ("mesh", None),
                                        ("e_rounds", 3),
                                        ("small_alpha", True)])
def test_jax_only_keywords_raise_type_error(knob, value):
    c = _small()
    with pytest.raises(TypeError, match=knob):
        ops.encode_lanes(c["syms"], c["init"], c["enc_tables"], k=128, L=9,
                         W=c["W"], device="cpu", **{knob: value})
    with pytest.raises(TypeError, match=knob):
        ops.decode_lanes(np.zeros((2, 4, 128), np.uint32),
                         np.zeros((2, 128), np.int32), c["packs"], k=128,
                         L=9, R=7, device="cpu", **{knob: value})


def test_bad_shapes_raise_value_error():
    c = _small()
    kw = dict(k=128, L=9, device="cpu")
    with pytest.raises(ValueError, match="cannot hold"):  # 8 rounds of 9 bits
        ops.encode_lanes(c["syms"], c["init"], c["enc_tables"], W=2, **kw)
    with pytest.raises(ValueError, match="syms"):
        ops.encode_lanes(c["syms"][:, :, :64], c["init"], c["enc_tables"],
                         W=c["W"], **kw)
    with pytest.raises(ValueError, match="init_syms"):
        ops.encode_lanes(c["syms"], c["init"][:1], c["enc_tables"],
                         W=c["W"], **kw)
    with pytest.raises(ValueError, match="next_state"):
        ops.encode_lanes(c["syms"], c["init"], c["enc_tables"], W=c["W"],
                         k=128, L=10, device="cpu")
    words, sizes = ops.encode_lanes(c["syms"], c["init"], c["enc_tables"],
                                    W=c["W"], **kw)
    with pytest.raises(ValueError, match="k must match"):
        ops.decode_lanes(words, sizes, c["packs"], k=256, L=9, R=7,
                         device="cpu")
    with pytest.raises(ValueError, match="dec"):
        ops.decode_lanes(words, sizes, c["packs"][:, :256], k=128, L=9,
                         R=7, device="cpu")
    with pytest.raises(ValueError, match="sizes"):
        ops.decode_lanes(words, sizes[:1], c["packs"], k=128, L=9, R=7,
                         device="cpu")


def test_ops_exports_the_jax_entries():
    import entropy_coders_tpu.ops as jops

    assert set(jops.__all__) <= set(ops.__all__)
    for name in ("decode_lanes", "encode_lanes", "encode_w_bound"):
        assert getattr(ops, name) is getattr(PL, name)
    for R in (1, 2, 17, 1023, 2047):
        for L in range(5, 16):
            assert ops.encode_w_bound(R, L) == JPL.encode_w_bound(R, L)


@pytest.mark.parametrize("n,gen", [(0, full), (1, full), (1000, geo),
                                   (4096, narrow), (70000, full)])
def test_histogram_u8_matches_jax(n, gen):
    data = gen(np.random.default_rng(n), n)
    want = np.asarray(jax_histogram_u8(data))
    got = histogram_u8(data, device="cpu")
    assert got.shape == (256,) and got.dtype == torch.int64
    assert (got.numpy() == want).all()
    assert torch.equal(histogram_u8(torch.from_numpy(data)), got)
    with pytest.raises(ValueError, match=r"\(n,\) uint8"):
        histogram_u8(torch.from_numpy(data).reshape(1, -1))

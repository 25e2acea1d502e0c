"""The launch-shape tool of B1 and B2 (``entropy_coders_tpu_torch.tools.
lane_shapes``) and the kernels' wrapper guards, on the CPU: the inputs it
builds, the bounds it computes from shapes, sizes and SASS counts, its
reading of SASS listings (hand-made ones, in ``cuobjdump -sass``'s
format), the wrappers' launch picks and their 32-bit index and alignment
guards. Tolerance: exact for counts; the times are checked against the
same arithmetic written out by hand (``pytest.approx``'s default)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu_torch.normalize import normalize_batch  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.tools import lane_shapes as LS  # noqa: E402
from entropy_coders_tpu_torch.tools.bench_data import gen_sequence  # noqa: E402


def test_shapes_are_the_main_path_chunks():
    """Each launch shape holds ~64 MiB, the container's chunk."""
    for name, s in LS.SHAPES.items():
        assert s["B"] * s["block"] == 64 << 20, name
        assert s["block"] % s["k"] == 0 and s["k"] % 128 == 0


def test_default_log_is_the_policy_mode():
    data = gen_sequence(0.2, 64 << 10, 3)
    counts = np.stack([np.bincount(b, minlength=256)
                       for b in data.reshape(-1, 8192)])
    _, logs = normalize_batch(counts, 8192, LS.DEFAULT_POLICY)
    vals, n = np.unique(logs, return_counts=True)
    assert LS.default_log(data, 8192) == vals[np.argmax(n)]


@pytest.mark.parametrize("L", [None, 9])
def test_shape_inputs_round_trip_on_cpu(monkeypatch, L):
    monkeypatch.setitem(LS.SHAPES, "tiny", dict(B=3, block=4096, k=128, L=L))
    data = gen_sequence(0.2, 3 * 4096, 5)
    inp = LS.shape_inputs("tiny", data, "cpu")
    assert (inp.B, inp.k, inp.R) == (3, 128, 31)
    assert inp.L == (L or LS.default_log(data, 4096))
    assert inp.W == PL.encode_w_bound(31, inp.L)
    words, sizes = LS.run_new("encode", inp)
    assert torch.equal(sizes, inp.sizes)
    syms, finals, cur = LS.run_new("decode", inp)
    assert not cur.any()
    got = torch.cat([syms.reshape(3, -1), finals], 1)
    assert torch.equal(got, inp.blocks)


STATS = {"per_round": {"issue": 16.0, "alu": 10.0, "fma": 3.0, "lsu": 3.0},
         "chain_cycles": 50.0}


@pytest.mark.parametrize("kind", ["decode", "encode"])
def test_bound_counts(kind):
    B, k, L, R, W = 2, 128, 8, 31, 16
    sizes = torch.full((B, k), 33, dtype=torch.int32)  # 2 words a lane
    b = LS.bound(kind, B=B, k=k, L=L, R=R, W=W, sizes=sizes, stats=STATS,
                 sm_max_mhz=1000.0, n_sm=2)
    lanes = B * k
    if kind == "decode":
        want = 4 * 2 * lanes + 4 * lanes + 4 * B * 256 + lanes * R + lanes \
            + 4 * lanes
    else:
        want = lanes * (R + 1) + B * 2048 + 2 * B * 256 + 4 * lanes * W \
            + 4 * lanes
    assert b["bytes"] == want
    assert b["int_ops"] == 13 * lanes * R
    warp_rounds = lanes // 32 * R
    # the ALU: 10 a round at 2 warp instructions an SM a clock, 2 SMs at 1 GHz
    assert b["pipe"] == "alu"
    assert b["ops_ms"] == pytest.approx(10 / 2 * warp_rounds / 2e9 * 1e3)
    assert b["pipe_ms"]["issue"] == pytest.approx(
        16 / 4 * warp_rounds / 2e9 * 1e3)
    assert b["chain_ms"] == pytest.approx(R * 50 / 1e9 * 1e3)
    assert b["bytes_ms"] == pytest.approx(want / 3.35e12 * 1e3)
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"])
    assert b["bound_by"] == ("bytes" if b["bytes_ms"] >= b["ops_ms"]
                             else "operations")
    three = {"bytes": b["bytes_ms"], "operations": b["ops_ms"],
             "chain": b["chain_ms"]}
    assert b["binds"] == max(three, key=three.get)


@pytest.mark.parametrize("extent", [(1 << 31) - 1, 1 << 31])
def test_index_range_guard(extent):
    if extent < 1 << 31:
        PL._check_index_range(W_k=extent)
    else:
        with pytest.raises(ValueError, match="32-bit"):
            PL._check_index_range(W_k=extent)
    # an unsigned byte offset reaches twice as far
    PL._check_index_range(word_bytes=extent, bound=1 << 32)


def _meta_encode(k, R, W, L=5):
    """``encode_call`` on tensors of the meta device (no data): the
    wrapper's checks run as for a CUDA tensor, up to the launch."""
    meta = torch.device("meta")
    blocks = torch.empty((1, (R + 1) * k), dtype=torch.uint8, device=meta)
    tabs = PL.LaneTables(
        torch.empty((1, 1 << L), dtype=torch.uint32, device=meta),
        torch.empty((1, 256), dtype=torch.uint32, device=meta),
        torch.empty((1, 256), dtype=torch.int32, device=meta),
        torch.empty((1, 1 << L), dtype=torch.uint16, device=meta))
    return PL.encode_call(blocks, tabs, k=k, L=L, W=W)


@pytest.mark.parametrize("W", [8, 16])
def test_encode_guards_word_byte_offsets(W):
    """B2 keeps a lane's word offset as a 32-bit byte offset, 4 * row * k:
    W * k = 2^30 would wrap it, and the wrapper refuses it before a launch;
    just below, it goes on to the device check."""
    k = (1 << 30) // 16 - 128 if W == 16 else (1 << 30) // 8
    want = "32-bit" if W * k >= 1 << 30 else "unsupported device"
    with pytest.raises(ValueError, match=want):
        _meta_encode(k, 1, W)


def test_aligned_copies_only_a_misaligned_tensor():
    t = torch.arange(64, dtype=torch.int32)
    assert PL._aligned(t) is t
    view = t.view(torch.uint8)[4:68]
    got = PL._aligned(view)
    assert got is not view and got.data_ptr() % 16 == 0
    assert torch.equal(got, view)


def _fake_sass(name, marks_gap, n_marks, mark):
    """A ``cuobjdump -sass``-like listing: ``n_marks`` round marks, each
    after ``marks_gap - 1`` other instructions."""
    lines = [f"\t\tFunction : _ZN_{name}EEEvPKj", ""]
    addr = 0
    for _ in range(n_marks):
        for op in ["IADD3 R1, R1, 0x1, RZ ;"] * (marks_gap - 1) + [f"{mark} [R2], R3 ;"]:
            lines.append(f"        /*{addr:04x}*/                   {op}")
            addr += 16
    return "\n".join(lines)


LAT = {"SHF": 2.5, "LOP3": 3.0, "IMAD": 4.0, "ADD_SHF": 9.0, "LDS": 30.0}


@pytest.mark.parametrize("kind", ["decode", "encode"])
def test_sass_per_round_counts_the_tightest_tile(kind):
    name = ("pl_decode_kernelILi256ELi2" if kind == "decode"
            else "pl_encode_kernelILi256ELi4")
    mark = LS._ROUND_MARK[kind]
    # a loose remainder loop (20 a round) and the unrolled tile (13 a round)
    text = (_fake_sass(name, 20, 40, mark) + "\n"
            + _fake_sass(name, 13, 40, mark).split("\n", 2)[2])
    st = LS.round_stats(text, kind, 256, 2 if kind == "decode" else 4, LAT)
    assert st["per_round"]["issue"] == 13
    assert st["per_round"]["alu"] == 12  # the IADD3s
    assert st["per_round"]["lsu"] == 1   # the mark
    assert st["per_round"]["fma"] == 0
    # one chain of IADD3s through R1: 12 a round at the least latency, 2.5
    assert st["chain_cycles"] == pytest.approx(12 * 2.5)
    # in order, each IADD3 waits for the last: the same
    assert st["inorder_cycles"] == pytest.approx(12 * 2.5, rel=0.01)
    assert LS.round_stats(text, kind, 512, 2, LAT) is None


def _listing(*lines):
    return "\n".join(f"        /*{16 * i:04x}*/                   {x}"
                     f"  /* 0x0000 */" for i, x in enumerate(lines))


@pytest.mark.parametrize("line, dests, srcs", [
    ("IMAD.IADD R20, R20, 0x1, R31 ;", ("R20",), ("R20", "R31")),
    ("LDS.64 R20, [R21] ;", ("R20", "R21"), ("R21",)),
    ("LDS R31, [R31+UR10+0x4800] ;", ("R31",), ("R31", "UR10")),
    ("ISETP.GT.U32.AND P1, PT, R34, 0x1f, PT ;", ("P1",), ("R34",)),
    ("IADD3 R30, P2, R29, R22, RZ ;", ("R30", "P2"), ("R29", "R22")),
    ("IMAD.X R31, RZ, RZ, R19, P2 ;", ("R31",), ("R19", "P2")),
    ("@P0 STG.E desc[UR16][R30.64], R33 ;", (), ("UR16", "R30", "R31", "R33",
                                                  "P0")),
    ("SEL R33, R32, R33, !P1 ;", ("R33",), ("R32", "R33", "P1")),
    ("SHF.R.U64 R14, R32, R35, R33 ;", ("R14",), ("R32", "R35", "R33")),
    ("@!P1 LDS R32, [R14+UR23] ;", ("R32",), ("R14", "UR23", "P1")),
    ("STS.U8 [R9+UR14+0x100], R18 ;", (), ("R9", "UR14", "R18")),
    ("BAR.SYNC.DEFER_BLOCKING 0x0 ;", (), ()),
])
def test_parse_sass_reads_dests_and_sources(line, dests, srcs):
    (x,) = LS.parse_sass(_listing(line))
    assert x.dests == dests
    assert x.srcs == srcs
    assert x.guarded == line.startswith("@")


def test_chain_takes_the_longest_dependent_path():
    text = _listing(
        "LDS R1, [R2] ;",                  # 30
        "IADD3 R3, R1, R4, RZ ;",          # 32.5: waits for R1, least latency
        "LOP3.LUT R5, R6, R7, RZ, 0xc0, !PT ;",  # 3, beside it
        "SHF.R.U32.HI R3, RZ, 0x2, R3 ;",  # 35
        "IMAD R8, R3, R5, RZ ;",           # 39
        "ISETP.GE.AND P0, PT, R8, 0x14, PT ;",  # 41.5
        "@!P0 LDS R9, [R8] ;")             # 71.5 if it runs, else 41.5
    insns = LS.parse_sass(text)
    assert LS.chain_cycles(insns, LAT) == pytest.approx(41.5)
    assert LS.chain_cycles(insns[:-1], LAT) == pytest.approx(41.5)
    assert LS.chain_cycles(insns[:5], LAT) == pytest.approx(39)
    # in order the LOP3 issues after the IADD3 (at 31, not at 1); the path
    # is the chain's, with the last LDS: 0 + 30, +2.5, +2.5, +4, +2.5, +30
    assert LS.inorder_cycles(insns, LAT) == pytest.approx(71.5)
    # an independent instruction behind a load issues at once
    assert LS.inorder_cycles(LS.parse_sass(_listing(
        "LOP3.LUT R5, R6, R7, RZ, 0xc0, !PT ;", "LDS R1, [R2] ;")), LAT) \
        == pytest.approx(31)


@pytest.mark.parametrize("op, want", [
    ("IADD3", ["issue", "alu"]), ("SHF.R.U32.HI", ["issue", "alu"]),
    ("IMAD.MOV.U32", ["issue", "fma"]), ("LDS.U8", ["issue", "lsu"]),
    ("STG.E", ["issue", "lsu"]), ("UIADD3", ["issue"]), ("BRA", ["issue"])])
def test_pipes(op, want):
    assert LS.pipes(op) == want


def test_every_matches_the_launchers():
    """The wrapper's picks keep the kernels exact, as the launchers check:
    T divides k, F rounds of at most L bits fit B2's 32-bit flush, and B1
    checks its refill every 2 rounds only while two rounds take at most 20
    bits (L <= 10)."""
    for L in range(5, 16):
        for k in (128, 256, 384, 1024, 8192, 16384):
            T, F = PL.lane_config("encode", k, L)
            assert k % T == 0 and T in LS.THREADS and F * L <= 32
            T, RF = PL.lane_config("decode", k, L)
            assert k % T == 0 and T in LS.THREADS
            assert RF in (1, 2) and (RF == 1 or L <= 10)
    assert [PL.lane_config("encode", 16384, L)[1] for L in (5, 8, 9, 15)] \
        == [4, 4, 2, 2]
    assert [PL.lane_config("decode", 16384, L)[1] for L in (5, 10, 11, 15)] \
        == [2, 2, 1, 1]

"""The port's per-lane coder (entropy_coders_tpu_torch.ops.pl_coder) against
the JAX package's (entropy_coders_tpu.ops.pl_coder, Pallas kernels in
interpret mode) and against ``spec``.

On the CPU the port's wrappers run their plain PyTorch versions, so these
tests hold the plain versions byte-exact against the reference; the CUDA
kernels are held against the plain versions on the card by chip_smoke.py.
Tolerance: exact everywhere (integer codec, no rounding).

The JAX interpret cases cost seconds each, so a module-scoped fixture runs
each of them once and the L x k x Q matrix is covered against ``spec``
(jax-free, cheap)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu import native  # noqa: E402
from entropy_coders_tpu.normalize import normalize_batch  # noqa: E402
from entropy_coders_tpu.ops import pl_coder as JPL  # noqa: E402
from entropy_coders_tpu.ops.histogram import histogram_blocks as jax_hist  # noqa: E402
from entropy_coders_tpu.spec.bitstream import BitStackWriter  # noqa: E402
from entropy_coders_tpu.spec.fse import DecodeTable, EncodeTable, Encoder  # noqa: E402
from entropy_coders_tpu.spec.histogram import NormHistogram  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.ops.histogram import histogram_blocks  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import to_numpy  # noqa: E402


def make_blocks(seed, B, k, Q, alphabet):
    """(B, k*Q) uint8 blocks: ``alphabet`` distinct symbols uniform, or
    "geo" for a geometric distribution whose top symbol's normalized count
    exceeds 256 at L >= 11."""
    rng = np.random.default_rng(seed)
    n = k * Q
    if alphabet == "geo":
        return (rng.geometric(0.2, (B, n)) - 1).clip(0, 255).astype(np.uint8)
    return rng.integers(0, alphabet, (B, n)).astype(np.uint8)


def norm_at(blocks, L):
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks])
    nt, l2 = normalize_batch(counts, blocks.shape[1], L)
    assert (l2 == L).all(), (l2, L)
    return nt


def port_encode(blocks, nt, k, L):
    R = blocks.shape[1] // k - 1
    words, sizes = PL.encode_lanes_norm(torch.from_numpy(blocks), nt, k=k,
                                        L=L, W=PL.encode_w_bound(R, L))
    return to_numpy(words), sizes.numpy()


def port_decode(words, sizes, nt, k, L, R):
    syms, finals = PL.decode_lanes_norm(
        torch.from_numpy(np.array(words)),  # a writable copy
        torch.from_numpy(np.array(sizes, np.int32)), nt, k=k,
        L=L, R=R)
    return syms.numpy(), finals.numpy()


def spec_lane_stream(seq, enc: EncodeTable):
    """Reference-format single-stream payload of one lane (no header, no
    marker bit): init folds the last byte, the rest codes in reverse, the
    final state closes it."""
    out = bytearray()
    w = BitStackWriter(out)
    e = Encoder.new_first_symbol(enc, int(seq[-1]))
    for b in seq[-2::-1]:
        e.encode(w, int(b))
    e.finish(w)
    bits = w.finish()
    return bytes(out), bits


# --- against the JAX package (interpret mode) --------------------------------

# (L, k, Q, B, alphabet): Q = 18 gives R % 3 == 2, the packed-encode gate of
# the JAX package's default E = 3 route; "geo" at L >= 11 has a count > 256
JAX_CASES = [
    (5, 128, 18, 2, 16),
    (8, 256, 16, 2, 64),
    (9, 256, 18, 1, 128),
    (11, 128, 18, 1, "geo"),
    (11, 256, 2, 2, 256),
    (13, 128, 16, 1, 256),
]


@pytest.fixture(scope="module", params=JAX_CASES,
                ids=[f"L{c[0]}-k{c[1]}-Q{c[2]}-{c[4]}" for c in JAX_CASES])
def jax_case(request):
    L, k, Q, B, alphabet = request.param
    blocks = make_blocks(1000 + L * Q + k, B, k, Q, alphabet)
    nt = norm_at(blocks, L)
    R = Q - 1
    jw, js = JPL.encode_lanes_norm(blocks, nt, k=k, L=L,
                                   W=JPL.encode_w_bound(R, L), interpret=True)
    jw, js = np.asarray(jw), np.asarray(js)
    jsyms, jfin = JPL.decode_lanes_norm(jw, js, nt, k=k, L=L, R=R,
                                        interpret=True)
    return dict(L=L, k=k, R=R, blocks=blocks, nt=nt, jw=jw, js=js,
                jsyms=np.asarray(jsyms), jfin=np.asarray(jfin))


def test_encode_matches_jax(jax_case):
    c = jax_case
    words, sizes = port_encode(c["blocks"], c["nt"], c["k"], c["L"])
    assert (sizes == c["js"]).all()
    common = min(words.shape[1], c["jw"].shape[1])
    assert (words[:, :common] == c["jw"][:, :common]).all()
    assert not words[:, common:].any()
    assert (native.lane_merge_batch(words, sizes)
            == native.lane_merge_batch(c["jw"], c["js"]))


def test_decode_matches_jax(jax_case):
    c = jax_case
    syms, finals = port_decode(c["jw"], c["js"], c["nt"], c["k"], c["L"],
                               c["R"])
    assert (syms == c["jsyms"]).all() and (finals == c["jfin"]).all()
    B = syms.shape[0]
    got = np.concatenate([syms.reshape(B, -1), finals], axis=1)
    assert (got == c["blocks"]).all()


# --- the L x k x Q matrix against spec -----------------------------------------

ALPHABET_AT = {5: 16, 8: 64, 11: "geo", 13: 256, 15: 256}


@pytest.mark.parametrize("Q", [2, 16, 18])
@pytest.mark.parametrize("k", [128, 256])
@pytest.mark.parametrize("L", [5, 8, 11, 13, 15])
def test_lanes_match_spec(L, k, Q):
    B = 2
    blocks = make_blocks(L * 1000 + k + Q, B, k, Q, ALPHABET_AT[L])
    nt = norm_at(blocks, L)
    words, sizes = port_encode(blocks, nt, k, L)
    merged = native.lane_merge_batch(words, sizes)
    for b in range(B):
        enc = EncodeTable(NormHistogram(nt[b], L, int(np.flatnonzero(nt[b])[-1]) + 1))
        payloads, bits = zip(*(spec_lane_stream(blocks[b, i::k], enc)
                               for i in range(k)))
        assert (sizes[b] == np.array(bits)).all()
        assert merged[b] == b"".join(payloads)
    syms, finals = port_decode(words, sizes, nt, k, L, Q - 1)
    got = np.concatenate([syms.reshape(B, -1), finals], axis=1)
    assert (got == blocks).all()


def test_tables_from_norm_match_spec():
    blocks = make_blocks(7, 2, 128, 16, "geo")
    nt = norm_at(blocks, 11)
    t = PL.tables_from_norm(nt, 11, "cpu")
    assert t.dec.dtype == torch.uint32 and t.next_state.dtype == torch.uint16
    for b in range(2):
        hist = NormHistogram(nt[b], 11, int(np.flatnonzero(nt[b])[-1]) + 1)
        enc, dec = EncodeTable(hist), DecodeTable(hist)
        assert (to_numpy(t.dec)[b] == dec.packed).all()
        assert (to_numpy(t.next_state)[b] == enc.table).all()
        assert (to_numpy(t.tt_bits)[b] == enc.tt_bits).all()
        assert (t.tt_fs.numpy()[b] == enc.tt_find_state).all()


# --- contracts ---------------------------------------------------------------


def test_corrupt_stream_raises():
    k, Q, L = 128, 18, 11
    blocks = make_blocks(3, 1, k, Q, "geo")
    nt = norm_at(blocks, L)
    words, sizes = port_encode(blocks, nt, k, L)
    bad = sizes.copy()
    # past anything 17 rounds can consume: the lane cannot drain to 0
    bad[0, 3] ^= 0x4000
    with pytest.raises(ValueError, match="lane cursor not drained"):
        port_decode(words, bad, nt, k, L, Q - 1)


def test_cpu_tensors_launch_no_kernel():
    before = (PL.DECODE_LAUNCHES, PL.ENCODE_LAUNCHES)
    blocks = make_blocks(4, 2, 128, 4, 64)
    nt = norm_at(blocks, 8)
    words, sizes = port_encode(blocks, nt, 128, 8)
    port_decode(words, sizes, nt, 128, 8, 3)
    assert (PL.DECODE_LAUNCHES, PL.ENCODE_LAUNCHES) == before == (0, 0)


def test_wrappers_check_inputs():
    blocks = make_blocks(5, 1, 128, 4, 64)
    nt = norm_at(blocks, 8)
    t = PL.tables_from_norm(nt, 8, "cpu")
    bt = torch.from_numpy(blocks)
    W = PL.encode_w_bound(3, 8)
    with pytest.raises(ValueError, match="multiple of 128"):
        PL.encode_call(bt[:, :-128].contiguous(), t, k=96, L=8, W=W)
    with pytest.raises(ValueError, match="dtype"):
        PL.encode_call(bt.to(torch.int32), t, k=128, L=8, W=W)
    with pytest.raises(ValueError, match="cannot hold"):
        PL.encode_call(bt, t, k=128, L=8, W=0)
    words, sizes = PL.encode_call(bt, t, k=128, L=8, W=W)
    with pytest.raises(ValueError, match="shape"):
        PL.decode_call(words, sizes[:, :64], t.dec, L=8, R=3)
    with pytest.raises(ValueError, match="contiguous"):
        strided = words.view(torch.int32).transpose(1, 2).contiguous()
        PL.decode_call(strided.transpose(1, 2).view(torch.uint32), sizes,
                       t.dec, L=8, R=3)


def test_histogram_matches_jax():
    blocks = make_blocks(6, 3, 128, 9, "geo")
    got = histogram_blocks(torch.from_numpy(blocks))
    assert got.dtype == torch.int64
    assert (got.numpy() == np.asarray(jax_hist(blocks))).all()

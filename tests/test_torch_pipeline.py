"""The per-lane path's chunk pipeline (``lazy=True`` on
``ops.pl_coder.encode_lanes_norm``/``decode_lanes_norm``, the
dispatch-all-then-drain loops of ``frame._encode_dispatch_pl`` /
``_encode_drain_pl`` and ``frame._decode_dispatch_pl`` /
``_decode_drain_pl``) on the CPU, where ``collect`` returns the plain
versions' results.

Tolerance: exact. Frames are compared byte for byte with the JAX package's
(Pallas kernels in interpret mode) and with the port's one-chunk frame;
lazy results equal the eager ones bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu import frame as JF  # noqa: E402
from entropy_coders_tpu.normalize import normalize_batch  # noqa: E402
from entropy_coders_tpu_torch import frame as F  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402

BS, K = 4096, 128
KW = dict(block_size=BS, k=K, lanes=True, table_log=9)


def _spy(monkeypatch, name, log):
    """Wrap ``PL.<name>`` so that each lazy call logs ("dispatch", B) and
    each of its collects logs ("collect", B)."""
    real = getattr(PL, name)

    def wrapped(first, *a, lazy=False, **kw):
        out = real(first, *a, lazy=lazy, **kw)
        if not lazy:
            return out
        B = first.shape[0]
        log.append(("dispatch", B))

        def collect():
            log.append(("collect", B))
            return out()

        return collect

    monkeypatch.setattr(PL, name, wrapped)


@pytest.fixture(scope="module")
def six_blocks():
    data = gen_sequence(0.2, 6 * BS, seed=41)
    return data, JF.compress(data, interpret=True, **KW)


def test_three_chunks_dispatched_before_first_collect(monkeypatch, six_blocks):
    """6 blocks at 2 blocks a chunk: all three kernels are dispatched before
    the first chunk is drained, on encode and on decode, and the frame is
    the JAX package's and the one-chunk frame, byte for byte."""
    data, jax_frame = six_blocks
    one_chunk = F.compress(data, device="cpu", **KW)
    monkeypatch.setattr(F, "_CHUNK_RAW", 2 * BS)
    log = []
    _spy(monkeypatch, "encode_lanes_norm", log)
    _spy(monkeypatch, "decode_lanes_norm", log)
    frame = F.compress(data, device="cpu", **KW)
    want = [("dispatch", 2)] * 3 + [("collect", 2)] * 3
    assert log == want
    assert frame == jax_frame == one_chunk
    log.clear()
    assert F.decompress(frame, device="cpu") == data.tobytes()
    assert log == want


def test_ragged_last_chunk(monkeypatch, six_blocks):
    """A chunk size that does not divide the block count: 4 + 2 blocks."""
    data, jax_frame = six_blocks
    monkeypatch.setattr(F, "_CHUNK_RAW", 4 * BS)
    log = []
    _spy(monkeypatch, "encode_lanes_norm", log)
    assert F.compress(data, device="cpu", **KW) == jax_frame
    assert log == [("dispatch", 4), ("dispatch", 2), ("collect", 4),
                   ("collect", 2)]


def _lane_case(B=3, R=15, L=9, seed=5):
    rng = np.random.default_rng(seed)
    blocks = (rng.geometric(0.2, (B, (R + 1) * K)) - 1).clip(0, 255).astype(
        np.uint8)
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks])
    nt, l2 = normalize_batch(counts, blocks.shape[1], L)
    assert (l2 == L).all()
    return torch.from_numpy(blocks), nt, R, L


def test_lazy_equals_eager():
    blocks, nt, R, L = _lane_case()
    W = PL.encode_w_bound(R, L)
    words, sizes = PL.encode_lanes_norm(blocks, nt, k=K, L=L, W=W)
    lw, ls = PL.encode_lanes_norm(blocks, nt, k=K, L=L, W=W, lazy=True)()
    assert lw.dtype == np.uint32 and ls.dtype == np.int32
    np.testing.assert_array_equal(lw.view(np.int32),
                                  words.view(torch.int32).numpy())
    np.testing.assert_array_equal(ls, sizes.numpy())
    syms, finals = PL.decode_lanes_norm(words.contiguous(), sizes, nt, k=K,
                                        L=L, R=R)
    lsyms, lfinals = PL.decode_lanes_norm(words.contiguous(), sizes, nt, k=K,
                                          L=L, R=R, lazy=True)()
    np.testing.assert_array_equal(lsyms, syms.numpy())
    np.testing.assert_array_equal(lfinals, finals.numpy())
    got = np.concatenate([lsyms.reshape(3, -1), lfinals], 1)
    np.testing.assert_array_equal(got, blocks.numpy())


def test_lazy_empty_batch():
    blocks, nt, R, L = _lane_case()
    words, sizes = PL.encode_lanes_norm(blocks[:0], nt[:0], k=K, L=L,
                                        W=PL.encode_w_bound(R, L), lazy=True)()
    assert words.shape == (0, 0, K) and sizes.shape == (0, K)


def test_collect_raises_on_undrained_cursor():
    """The drained-cursor check runs in ``collect``: a lane size pushed past
    anything R rounds consume dispatches fine, and collect raises."""
    blocks, nt, R, L = _lane_case()
    words, sizes = PL.encode_lanes_norm(blocks, nt, k=K, L=L,
                                        W=PL.encode_w_bound(R, L))
    bad = sizes.clone()
    bad[1, 3] ^= 0x4000
    collect = PL.decode_lanes_norm(words.contiguous(), bad, nt, k=K, L=L, R=R,
                                   lazy=True)
    with pytest.raises(ValueError, match="cursor not drained"):
        collect()
    with pytest.raises(ValueError, match="cursor not drained"):
        PL.decode_lanes_norm(words.contiguous(), bad, nt, k=K, L=L, R=R)

"""The port's shared-stream payload codec (``ops.coder.encode_interleaved``
/ ``decode_interleaved``) and its sanitizer (``utils.checked``) against the
JAX package's ``ops.coder`` and the executable spec (``spec.codec``), on the
CPU.

Tolerance: exact. Payloads are compared byte for byte, decoded bytes equal
the input, the checked cores' outputs equal the unchecked ones bit for
bit. Corruption raises ``ValueError`` (or decodes to some bytes, or gives
``None`` on a framing error), never another exception."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu.ops import coder as JC  # noqa: E402
from entropy_coders_tpu.spec.codec import fse_compress  # noqa: E402
from entropy_coders_tpu.spec.fse import DecodeTable, EncodeTable  # noqa: E402
from entropy_coders_tpu_torch import ops  # noqa: E402
from entropy_coders_tpu_torch.ops import coder as C  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import to_device  # noqa: E402
from entropy_coders_tpu_torch.utils import checked as CK  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402


def spec_payload(src, k):
    """(hist, the spec codec's payload after its histogram header)."""
    dst = bytearray()
    hist, _ = fse_compress(src, dst, k=k)
    hdr = bytearray()
    hist.write(hdr)
    return hist, bytes(dst)[len(hdr):]


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("size", [1025, 4096])
def test_encode_matches_jax_and_spec(k, size):
    src = gen_sequence(0.2, size, seed=size + k)
    hist, payload = spec_payload(src, k)
    table = EncodeTable(hist)
    got = C.encode_interleaved(src, k, table, hist.log2, device="cpu")
    assert got[0] == payload
    assert got == JC.encode_interleaved(src, k, table, hist.log2)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_decode_round_trip(k):
    src = gen_sequence(0.3, 2047, seed=k)
    hist, payload = spec_payload(src, k)
    table = DecodeTable(hist)
    out = C.decode_interleaved(payload, k, table, hist.log2,
                               max_out=len(src), device="cpu")
    assert out == src.tobytes()
    assert out == JC.decode_interleaved(payload, k, table, hist.log2,
                                        max_out=len(src))


def test_exported_from_ops():
    assert ops.encode_interleaved is C.encode_interleaved
    assert ops.decode_interleaved is C.decode_interleaved


def test_decode_framing_errors_give_none():
    """The JAX package's framing errors: an empty or all-zero payload, a
    marker bit more than 8 bits from the end, fewer than k * L bits."""
    src = gen_sequence(0.2, 1024)
    hist, payload = spec_payload(src, 2)
    table = DecodeTable(hist)
    for bad in (b"", b"\x00\x00", b"\x01\x00", b"\x01"):
        want = JC.decode_interleaved(bad, 2, table, hist.log2, 1024)
        assert want is None
        assert C.decode_interleaved(bad, 2, table, hist.log2, 1024,
                                    device="cpu") is None


def test_decode_capacity_too_small_raises():
    src = gen_sequence(0.2, 1024)
    hist, payload = spec_payload(src, 2)
    with pytest.raises(ValueError, match="capacity"):
        C.decode_interleaved(payload, 2, DecodeTable(hist), hist.log2,
                             max_out=100, device="cpu")


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = gen_sequence(0.2, 1024)
    hist, payload = spec_payload(src, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        C.encode_interleaved(src, 2, EncodeTable(hist), hist.log2)
    with pytest.raises(RuntimeError, match="CUDA"):
        C.decode_interleaved(payload, 2, DecodeTable(hist), hist.log2, 1024)


# --- the sanitizer -------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 64])
def test_checked_round_trip_matches_unchecked(k):
    src = gen_sequence(0.2, 4096)
    hist, payload = spec_payload(src, k)
    got = CK.checked_encode_interleaved(src, k, EncodeTable(hist), hist.log2,
                                        device="cpu")
    assert got == C.encode_interleaved(src, k, EncodeTable(hist), hist.log2,
                                       device="cpu")
    assert got[0] == payload
    out = CK.checked_decode_interleaved(payload, k, DecodeTable(hist),
                                        hist.log2, max_out=len(src),
                                        device="cpu")
    assert out == src.tobytes()


def _core_inputs(src, k, hist):
    """The shared-stream cores' batched inputs for one payload."""
    m, R, valid, finish_slots, W = C.encode_layout(len(src), k)
    syms, init_syms = C.blocks_to_syms(src[None], m, R, k)
    t = EncodeTable(hist)
    tables = tuple(to_device(a[None], "cpu")
                   for a in (t.table, t.tt_bits, t.tt_find_state))
    enc = (torch.from_numpy(np.ascontiguousarray(syms)),
           torch.from_numpy(valid), torch.from_numpy(init_syms),
           torch.from_numpy(finish_slots), tables)
    return enc, dict(k=k, L=hist.log2, W=W), R


def _stream(enc):
    """The one-stream arguments of the checked cores (the JAX package's)
    from the batched ones."""
    syms, valid, init, fin, (table, tt_bits, tt_fs) = enc
    return syms[0], valid, init[0], fin, tt_bits[0], tt_fs[0], table[0]


def test_checked_cores_equal_unchecked():
    src = gen_sequence(0.2, 3000, seed=9)
    hist, _ = spec_payload(src, 4)
    enc, kw, R = _core_inputs(src, 4, hist)
    words, bits = C.encode_core(*enc, **kw)
    cwords, cbits = CK.checked_encode_core(*_stream(enc), **kw)
    assert torch.equal(words[0], cwords) and torch.equal(bits[0], cbits)
    packed = to_device(np.asarray(DecodeTable(hist).packed, np.uint32)[None],
                       "cpu")
    dec = (torch.cat([words, torch.zeros((1, 2), dtype=torch.int64)], 1),
           bits, packed)
    plain = C.decode_core(*dec, k=4, L=hist.log2, R=R + 1)
    checked = CK.checked_decode_core(dec[0][0], dec[1][0], dec[2][0], k=4,
                                     L=hist.log2, R=R + 1)
    for a, b in zip(plain, checked):
        assert torch.equal(a[0], b)


def test_checked_cores_raise_value_error_on_out_of_range():
    """Indices the unchecked cores clamp (or leave torch to reject) raise
    ValueError under the sanitizer: a next-state table too small for the
    table log (encode), a decode table too small for it, and a bit offset
    past the payload's words (decode)."""
    src = gen_sequence(0.2, 3000, seed=9)
    hist, _ = spec_payload(src, 4)
    enc, kw, R = _core_inputs(src, 4, hist)
    syms, valid, init, fin, (table, tt_bits, tt_fs) = enc
    small = (table[:, : table.shape[1] // 2].contiguous(), tt_bits, tt_fs)
    C.encode_core(syms, valid, init, fin, small, **kw)  # clamps silently
    with pytest.raises(ValueError, match="out of range"):
        CK.checked_encode_core(*_stream((syms, valid, init, fin, small)),
                               **kw)

    words, bits = C.encode_core(*enc, **kw)
    words = torch.cat([words, torch.zeros((1, 2), dtype=torch.int64)], 1)
    packed = to_device(np.asarray(DecodeTable(hist).packed, np.uint32)[None],
                       "cpu")
    half = packed[:, : packed.shape[1] // 2].contiguous()
    with pytest.raises(RuntimeError):  # torch's own gather check
        C.decode_core(words, bits, half, k=4, L=hist.log2, R=R + 1)
    with pytest.raises(ValueError, match="out of range"):
        CK.checked_decode_core(words[0], bits[0], half[0], k=4, L=hist.log2,
                               R=R + 1)
    past = bits + 32 * words.shape[1]
    C.decode_core(words, past, packed, k=4, L=hist.log2, R=R + 1)  # clamps
    with pytest.raises(ValueError, match="bit offset"):
        CK.checked_decode_core(words[0], past[0], packed[0], k=4, L=hist.log2,
                               R=R + 1)


def test_checked_decode_survives_corruption():
    """Corrupted payloads under the sanitizer decode to some bytes (wrong
    bytes are in contract without checksums), give None or raise
    ValueError: never a raw IndexError/RuntimeError."""
    src = gen_sequence(0.2, 1024)
    hist, payload = spec_payload(src, 2)
    table = DecodeTable(hist)
    rng = np.random.default_rng(5)
    for _ in range(16):
        bad = bytearray(payload)
        bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        try:
            out = CK.checked_decode_interleaved(bytes(bad), 2, table,
                                                hist.log2, max_out=len(src),
                                                device="cpu")
            assert out is None or isinstance(out, bytes)
        except ValueError:
            pass

"""The port's container codec (entropy_coders_tpu_torch.frame) against the
JAX package's (entropy_coders_tpu.frame, Pallas kernels in interpret mode)
and the pinned golden frames, on the CPU (``device="cpu"``: the kernels'
plain PyTorch versions).

Tolerance: exact. Frames are compared byte for byte (golden frames by
sha256), decoded bytes equal the input. JAX frames are built once per
configuration by a module-scoped fixture (each costs seconds)."""

import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu import frame as JF  # noqa: E402
from entropy_coders_tpu_torch import frame as F  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402
from tests.data.generate_golden import make_input, make_mixed  # noqa: E402

GOLDEN = Path(__file__).parent / "data" / "golden"
FRAME_CASES = [c for c in json.loads((GOLDEN / "manifest.json").read_text())
               if c["codec"] == "frame"]
KNOBS = ("block_size", "k", "lanes", "shared_table", "checksum", "table_log",
         "bit_pack")


def compress(data, **kw):
    return F.compress(data, device="cpu", **kw)


def decompress(frame, **kw):
    return F.decompress(frame, device="cpu", **kw)


# --- golden frames ---------------------------------------------------------------


@pytest.mark.parametrize("case", FRAME_CASES, ids=[c["name"] for c in FRAME_CASES])
def test_golden_frame_reproduced(case):
    spec = case["input"]
    data = (make_mixed(spec["size"], spec["seed"])
            if spec["kind"] == "mixed_rle_raw" else make_input(spec))
    frame = compress(data, **{kk: case[kk] for kk in KNOBS if kk in case})
    assert hashlib.sha256(frame).hexdigest() == case["sha256"]
    assert decompress((GOLDEN / case["file"]).read_bytes()) == data.tobytes()


# --- byte identity with the JAX package ----------------------------------------------

# name -> (input size, knobs); 4096-byte blocks at k=256 (16 bytes per lane)
# unless noted. "tail" sizes leave a ragged block that is not
# lane-divisible, which takes the shared-stream MODE_FSE path.
JAX_CONFIGS = {
    "tail_checksum": (3 * 4096 + 777, dict(block_size=4096, k=256,
                                            checksum=True)),
    "shared_table": (4 * 4096, dict(block_size=4096, k=256,
                                    shared_table=True)),
    # the shared counts from the full blocks' device histograms plus the
    # tail's, and from the tail alone (lane-divisible: the per-lane path)
    "shared_table_tail": (3 * 4096 + 777, dict(block_size=4096, k=256,
                                               shared_table=True)),
    "shared_table_no_full_block": (12 * 256, dict(block_size=4096, k=256,
                                                  shared_table=True)),
    "bit_pack": (2 * 4096 + 512, dict(block_size=4096, k=256,
                                      bit_pack=True)),
    "default_policy": (2 * 2048 + 100, dict(block_size=2048, k=128)),
}


@pytest.fixture(scope="module")
def jax_frames():
    """name -> (data, JAX frame), built once."""
    out = {}
    for name, (size, kw) in JAX_CONFIGS.items():
        data = gen_sequence(0.2, size, seed=len(out) + 21)
        out[name] = (data, JF.compress(data, lanes=True, interpret=True, **kw))
    return out


@pytest.mark.parametrize("name", list(JAX_CONFIGS))
def test_frame_matches_jax(name, jax_frames):
    data, jframe = jax_frames[name]
    frame = compress(data, lanes=True, **JAX_CONFIGS[name][1])
    assert frame == jframe
    # the JAX package's frame decodes in the port
    assert decompress(jframe) == data.tobytes()


@pytest.mark.parametrize("name", ["tail_checksum", "bit_pack"])
def test_jax_decodes_port_frame(name, jax_frames):
    data, _ = jax_frames[name]
    frame = compress(data, lanes=True, **JAX_CONFIGS[name][1])
    assert JF.decompress(frame, interpret=True) == data.tobytes()


def test_shared_stream_matches_jax():
    """lanes=False: every block takes the shared-stream MODE_FSE path
    (ops.coder), byte-identical to the JAX package's."""
    data = gen_sequence(0.3, 3 * 1024 + 100, seed=31)
    kw = dict(block_size=1024, k=4, lanes=False)
    frame = compress(data, **kw)
    assert frame == JF.compress(data, **kw)
    pf = F._parse_frame(frame)
    assert (pf.modes == F.MODE_FSE).all()
    assert decompress(frame) == data.tobytes()
    assert JF.decompress(frame) == data.tobytes()


def test_lanes_default_follows_device():
    """lanes=None resolves to the per-lane path on CUDA only: on the CPU
    the frame is the shared-stream one."""
    data = gen_sequence(0.2, 2 * 4096, seed=33)
    pf = F._parse_frame(compress(data, block_size=4096, k=256))
    assert (pf.modes == F.MODE_FSE).all()
    pf = F._parse_frame(compress(data, block_size=4096, k=256, lanes=True))
    assert (pf.modes == F.MODE_FSE_PL).all()


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the device='cuda' default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        F.compress(b"abc" * 100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        F.decompress(compress(b"abc" * 100))


# --- range decode and out= ------------------------------------------------------------


@pytest.fixture(scope="module")
def pl_frame():
    data = gen_sequence(0.2, 3 * 4096 + 123, seed=41)
    return data, compress(data, block_size=4096, k=128, lanes=True)


@pytest.mark.parametrize("start,length", [(0, None), (100, 5000),
                                          (4096, 4096), (12000, 411),
                                          (12288, 0)])
def test_range_decode(pl_frame, start, length):
    data, frame = pl_frame
    end = len(data) if length is None else start + length
    assert decompress(frame, start=start, length=length) == \
        data[start:end].tobytes()


@pytest.mark.parametrize("start,length", [(0, None), (4096, 4096),
                                          (100, 5000)])
def test_out_buffer(pl_frame, start, length):
    data, frame = pl_frame
    end = len(data) if length is None else start + length
    buf = bytearray(end - start + 7)
    assert decompress(frame, start=start, length=length, out=buf) == end - start
    assert bytes(buf[: end - start]) == data[start:end].tobytes()


def test_out_buffer_errors(pl_frame):
    data, frame = pl_frame
    with pytest.raises(ValueError, match="too small"):
        decompress(frame, out=bytearray(10))
    with pytest.raises(ValueError, match="read-only"):
        decompress(frame, out=bytes(len(data)))
    with pytest.raises(ValueError, match="range outside frame"):
        decompress(frame, start=len(data) + 1)


# --- corruption: ValueError only ---------------------------------------------------------


def test_bad_magic_and_version(pl_frame):
    _, frame = pl_frame
    with pytest.raises(ValueError, match="bad magic"):
        decompress(b"XXXX" + frame[4:])
    bad = bytearray(frame)
    bad[4] = 99
    with pytest.raises(ValueError, match="unsupported version"):
        decompress(bytes(bad))


def test_truncated_frame(pl_frame):
    _, frame = pl_frame
    for cut in range(0, len(frame), max(1, len(frame) // 48)):
        with pytest.raises(ValueError):
            decompress(frame[:cut])


def _lane_size_offset(frame):
    pf = F._parse_frame(frame)
    assert int(pf.modes[0]) == F.MODE_FSE_PL
    sec = pf.section(0)
    _, _, rest = F._read_block_header(sec)
    return pf, int(pf.offs[0]) + len(sec) - len(rest)


def test_lane_sizes_tampered(pl_frame):
    _, frame = pl_frame
    _, off = _lane_size_offset(frame)
    bad = bytearray(frame)
    bad[off: off + 2] = (0xFFFF).to_bytes(2, "little")  # lane 0: 65535 bits
    with pytest.raises(ValueError):
        decompress(bytes(bad))


def test_lane_sizes_amplification_bounded(pl_frame):
    """Move whole bytes of other lanes' sizes onto lane 0, keeping the total
    payload length: only the (R+1)*log2 bound can catch it."""
    _, frame = pl_frame
    pf, off = _lane_size_offset(frame)
    k = pf.k
    sz = np.frombuffer(frame[off: off + 2 * k], "<u2").astype(np.int64)
    tampered = sz.copy()
    budget = 60000 - int(sz[0])
    for j in range(1, k):
        give = min(int(tampered[j]) - 16 & ~7, budget & ~7)
        if give > 0:
            tampered[j] -= give
            tampered[0] += give
            budget -= give
    assert tampered[0] > 16 * (pf.block_size // k)
    assert ((tampered + 7) // 8).sum() == ((sz + 7) // 8).sum()
    bad = bytearray(frame)
    bad[off: off + 2 * k] = tampered.astype("<u2").tobytes()
    with pytest.raises(ValueError, match="bad lane sizes"):
        decompress(bytes(bad))


def test_packed_size_table_bomb_bounded():
    """A crafted low-entropy FSE stream as a FLAG_PACKED size table decodes
    to no more than the expected 2k bytes and raises ValueError."""
    from entropy_coders_tpu.spec.histogram import NormHistogram

    t = np.zeros(256, np.int32)
    t[0] = (1 << 15) - 1
    t[1] = 1
    hdr = bytearray()
    NormHistogram.try_from(t).write(hdr)
    bomb = bytes(hdr) + b"\xff" * 60
    sec = struct.pack("<H", len(bomb)) + bomb + b"lanes"
    with pytest.raises(ValueError):
        F._unpack_size_table(sec, 128)


@pytest.mark.parametrize("bit_pack", [False, True])
def test_random_corruption_raises_value_error_only(bit_pack):
    """Byte flips anywhere in a frame: a clean ValueError or a decode of the
    right length, nothing else."""
    data = gen_sequence(0.2, 2 * 4096 + 300, seed=43)
    frame = compress(data, block_size=4096, k=128, lanes=True,
                     bit_pack=bit_pack)
    rng = np.random.default_rng(bit_pack)
    errors = 0
    for _ in range(60):
        bad = bytearray(frame)
        bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        try:
            out = decompress(bytes(bad))
            assert isinstance(out, bytes) and len(out) == len(data)
        except ValueError:
            errors += 1
    assert errors > 0


def test_checksum_catches_corruption():
    data = gen_sequence(0.2, 2 * 4096, seed=45)
    frame = bytearray(compress(data, block_size=4096, k=128, lanes=True,
                               checksum=True))
    frame[-1] ^= 0x01  # last payload byte of the last block
    with pytest.raises(ValueError):
        decompress(bytes(frame))


def test_empty_and_tiny_inputs():
    assert decompress(compress(b"", lanes=False)) == b""
    for n in (1, 2, 7, 15, 16, 17):
        d = bytes(range(n))
        assert decompress(compress(d, block_size=16, k=2, lanes=False)) == d

"""The port's container codec (entropy_coders_tpu_torch.frame) against the
JAX package's (entropy_coders_tpu.frame, Pallas kernels in interpret mode)
and the pinned golden frames, on the CPU (``device="cpu"``: the kernels'
plain PyTorch versions).

Tolerance: exact. Frames are compared byte for byte (golden frames by
sha256), decoded bytes equal the input. JAX frames are built once per
configuration by a module-scoped fixture (each costs seconds)."""

import ctypes
import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu import frame as JF  # noqa: E402
from entropy_coders_tpu_torch import frame as F  # noqa: E402
from entropy_coders_tpu_torch.utils import profiling  # noqa: E402
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


# --- the returned bytes: decoded into in place ---------------------------------------


def _counts(before):
    now = profiling.counters
    return {key: now.get(key, 0) - before.get(key, 0)
            for key in ("decompress.in_place", "host_bytes.decompress.output",
                        "host_bytes.decompress.out_buffer")}


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "crc"])
def mixed_frame(request):
    """A frame of every block mode: RLE, RAW, two MODE_FSE_PL blocks and a
    777-byte MODE_FSE tail (not lane-divisible), 4 KiB blocks, k = 128."""
    bs = 4096
    rng = np.random.default_rng(47)
    data = np.concatenate([np.full(bs, 9, np.uint8),
                           rng.integers(0, 256, bs, np.uint8),
                           gen_sequence(0.2, 2 * bs + 777, seed=47)])
    frame = compress(data, block_size=bs, k=128, lanes=True,
                     checksum=request.param)
    assert F._parse_frame(frame).modes.tolist() == [
        F.MODE_RLE, F.MODE_RAW, F.MODE_FSE_PL, F.MODE_FSE_PL, F.MODE_FSE]
    return data, frame


@pytest.mark.parametrize("start,length", [(0, None), (4096, 3 * 4096 + 777),
                                          (4096, 2 * 4096)],
                         ids=["whole", "aligned_to_end", "aligned"])
def test_aligned_decode_returns_its_buffer(mixed_frame, start, length):
    data, frame = mixed_frame
    end = len(data) if length is None else start + length
    before = dict(profiling.counters)
    got = decompress(frame, start=start, length=length)
    assert _counts(before) == {"decompress.in_place": 1,
                               "host_bytes.decompress.output": end - start,
                               "host_bytes.decompress.out_buffer": 0}
    assert type(got) is bytes
    assert got == data[start:end].tobytes()
    assert got == JF.decompress(frame, start=start, length=length,
                                interpret=True)
    assert hash(got) == hash(bytes(bytearray(got)))  # no stale cached hash


def test_unaligned_range_stages_its_blocks(mixed_frame):
    data, frame = mixed_frame
    before = dict(profiling.counters)
    got = decompress(frame, start=100, length=5000)
    assert _counts(before) == {"decompress.in_place": 0,
                               "host_bytes.decompress.output": 5000,
                               "host_bytes.decompress.out_buffer": 2 * 4096}
    assert type(got) is bytes and got == data[100:5100].tobytes()


def test_empty_results_leave_the_empty_bytes_unwritten(pl_frame):
    _, frame = pl_frame
    empty_at = F._PyBytes_AsString(b"")
    assert ctypes.string_at(empty_at, 1) == b"\0"
    for got in (decompress(frame, start=4096, length=0),
                decompress(frame, start=0, length=0),
                decompress(compress(b"", lanes=False))):
        assert type(got) is bytes and got == b""
    # the shared empty object still holds its terminator alone
    assert F._PyBytes_AsString(b"") == empty_at
    assert ctypes.string_at(empty_at, 1) == b"\0"


def test_consecutive_results_share_no_buffer(pl_frame, mixed_frame):
    data_a, frame_a = pl_frame
    data_b, frame_b = mixed_frame
    a = decompress(frame_a)
    b = decompress(frame_b)
    c = decompress(frame_a)
    assert a == data_a.tobytes() and b == data_b.tobytes() and c == a
    assert len({F._PyBytes_AsString(x) for x in (a, b, c)}) == 3


def test_failed_decode_hands_out_nothing(mixed_frame):
    data, frame = mixed_frame
    bad = bytearray(frame)
    bad[-1] ^= 0x01  # a payload byte of the last (MODE_FSE) block
    before = dict(profiling.counters)
    with pytest.raises(ValueError):
        decompress(bytes(bad))
    assert _counts(before)["decompress.in_place"] == 1
    assert decompress(frame) == data.tobytes()


def _raises_zeroed(frame: bytes, n: int, match: str, **kw) -> None:
    """Decoding ``frame`` raises ValueError matching ``match``, and no
    result is handed out: in every frame of the call's traceback ``result``
    is None and the bytes the call decoded into (``n`` of them) are
    zeros."""
    with pytest.raises(ValueError, match=match) as err:
        decompress(frame, **kw)
    seen, tb = 0, err.tb
    while tb is not None:
        if tb.tb_frame.f_code.co_filename == F.__file__:
            local = tb.tb_frame.f_locals
            assert local.get("result") is None
            for v in local.values():
                if isinstance(v, (bytes, np.ndarray)) and len(v) == n:
                    assert not np.frombuffer(v, np.uint8).any()
                    seen += 1
        tb = tb.tb_next
    assert seen  # the decode's view, in the call's own frames


def test_failed_decode_leaves_no_written_bytes_reachable(mixed_frame):
    """A call that raises zeroes the bytes it was decoding into, so the
    traceback's frames reach none of its written, or never written, bytes:
    at the MODE_FSE tail's drain (only RAW and RLE written), at a per-lane
    block's drain (the tail written too) and, with crcs, at the crc check
    (every block written)."""
    data, frame = mixed_frame
    pf = F._parse_frame(frame)
    sites = {"fse_tail": len(frame) - 1,
             "pl_block": int(pf.offs[2] + pf.lens[2] // 2)}
    if pf.crcs is not None:
        sites["crc"] = frame.index(struct.pack("<I", int(pf.crcs[2])))
    for site, at in sites.items():
        bad = bytearray(frame)
        bad[at] ^= 0x01
        _raises_zeroed(bytes(bad), len(data), "")


@pytest.mark.parametrize("fault,message", [("zeros", "missing marker bit"),
                                           ("last_zero", "framing error")])
def test_fse_marker_checks_match_jax(fault, message):
    """A MODE_FSE payload with no set bit, or whose last byte is zero (its
    marker then lies more than 8 bits from the end), raises as in the JAX
    package."""
    data = gen_sequence(0.2, 2 * 1024, seed=49)
    frame = compress(data, block_size=1024, k=4, lanes=False)
    pf = F._parse_frame(frame)
    assert (pf.modes == F.MODE_FSE).all()
    _, _, payload = F._read_block_header(pf.section(1))
    at = int(pf.offs[1] + pf.lens[1]) - len(payload)
    bad = bytearray(frame)
    if fault == "zeros":
        bad[at: at + len(payload)] = bytes(len(payload))
    else:
        assert payload[0] and payload[-1]
        bad[at + len(payload) - 1] = 0
    with pytest.raises(ValueError, match=f"block 1: {message}"):
        decompress(bytes(bad))
    with pytest.raises(ValueError, match=f"block 1: {message}"):
        JF.decompress(bytes(bad))


# --- the crc32s on the device ---------------------------------------------------------

# name -> (input, knobs, virtual ranks): FLAG_CRC frames whose full blocks
# are checksummed where they lie (``ops.crc``; the plain version on the
# CPU), the ragged tail on the host; 4 KiB blocks at k = 256
CRC_CONFIGS = {
    "lanes": (4 * 4096, dict(), 1),
    "bit_pack_lane_tail": (2 * 4096 + 512, dict(bit_pack=True), 1),
    "fse_tail": (3 * 4096 + 777, dict(), 1),
    "fse_tail_mesh3": (5 * 4096 + 777, dict(), 3),
    "bit_pack_mesh2": (5 * 4096 + 512, dict(bit_pack=True), 2),
    "shared_table_mesh4": (3 * 4096 + 100, dict(shared_table=True), 4),
}


def _crc_data(name: str) -> np.ndarray:
    size = CRC_CONFIGS[name][0]
    data = gen_sequence(0.2, size, seed=size % 1000)
    if name.startswith("fse_tail"):  # an RLE and a RAW block on the host too
        data[4096: 2 * 4096] = 5
        data[2 * 4096: 3 * 4096] = np.random.default_rng(3).integers(
            0, 256, 4096, np.uint8)
    return data


def _on_ranks(n: int) -> dict:
    if n == 1:
        return dict(device="cpu")
    from entropy_coders_tpu_torch.parallel import block_sharding

    return dict(sharding=block_sharding((torch.device("cpu"),) * n))


@pytest.fixture(scope="module")
def crc_frames():
    """name -> (data, the JAX package's frame), built once."""
    out = {}
    for name, (_, kw, _) in CRC_CONFIGS.items():
        data = _crc_data(name)
        out[name] = (data, JF.compress(data, block_size=4096, k=256,
                                       lanes=True, checksum=True,
                                       interpret=True, **kw))
    return out


@pytest.mark.parametrize("name", list(CRC_CONFIGS))
def test_crc_frames_match_jax(name, crc_frames):
    """The crc tables written from the device's crcs are the JAX package's
    (``zlib.crc32`` on the host) byte for byte, with and without
    ``bit_pack``, with a ragged tail and on a virtual mesh of shares; each
    decodes, crcs checked, in both packages."""
    data, jframe = crc_frames[name]
    _, kw, n = CRC_CONFIGS[name]
    frame = F.compress(data, block_size=4096, k=256, lanes=True,
                       checksum=True, **kw, **_on_ranks(n))
    assert frame == jframe
    assert F.decompress(jframe, **_on_ranks(n)) == data.tobytes()
    assert JF.decompress(frame, interpret=True) == data.tobytes()


def _lane_starts(frame: bytes, block: int) -> list:
    """Frame offsets of the first byte of each lane stream of per-lane
    block ``block`` of an unpacked frame without a shared table."""
    pf = F._parse_frame(frame)
    sec = pf.section(block)
    _, _, payload = F._read_block_header(sec)
    at = int(pf.offs[block]) + len(sec) - len(payload) + 2 * pf.k
    sz = np.frombuffer(payload[: 2 * pf.k], "<u2").astype(np.int64)
    return (at + np.concatenate([[0], np.cumsum((sz + 7) >> 3)[:-1]])).tolist()


@pytest.fixture(scope="module")
def decodable_flip():
    """(data, crc frame, block, offset): one bit of a per-lane block's
    payload flipped so that the block still decodes, to other bytes (the
    lowest bit of a lane's stream is read last: it moves only the lane's
    final state). Found on the frame without crcs, whose sections are the
    same."""
    bs = 4096
    data = gen_sequence(0.2, 4 * bs + 300, seed=61)
    kw = dict(block_size=bs, k=128, lanes=True)
    plain, frame = compress(data, **kw), compress(data, checksum=True, **kw)
    pf = F._parse_frame(frame)
    block = 2
    assert pf.modes[block] == F.MODE_FSE_PL
    shift = len(frame) - len(plain)  # the crc table
    for at in _lane_starts(plain, block):
        bad = bytearray(plain)
        bad[at] ^= 0x01
        try:
            got = decompress(bytes(bad))
        except ValueError:
            continue
        if got != data.tobytes():
            return data, frame, block, at + shift
    raise AssertionError("no decodable flip found")




@pytest.mark.parametrize("start,length", [(0, None), (2 * 4096, 4096),
                                          (4096, 3 * 4096),
                                          (4096 + 17, 2 * 4096)],
                         ids=["whole", "the_block", "around_it", "unaligned"])
def test_device_crc_catches_a_decodable_flip(decodable_flip, start, length):
    """A flipped payload bit that B1 decodes without complaint is caught
    by the block's crc, computed where it was decoded, on whole-frame and
    range reads; the bytes decoded into (the range's blocks, also where an
    unaligned range stages them) are zeroed, and a range without the block
    decodes."""
    data, frame, block, at = decodable_flip
    bad = bytearray(frame)
    bad[at] ^= 0x01
    n = len(data) if length is None else length
    lo, hi = start // 4096, -(-(start + n) // 4096)
    blocks = min(hi * 4096, len(data)) - lo * 4096
    _raises_zeroed(bytes(bad), blocks, f"block {block}: crc mismatch",
                   start=start, length=length)
    assert decompress(bytes(bad), start=0, length=2 * 4096) == \
        data[: 2 * 4096].tobytes()
    assert decompress(frame, start=start, length=length) == \
        data[start: start + n].tobytes()


@pytest.fixture
def crc_calls(monkeypatch):
    """Every call of the crc kernel's wrapper from the frame code, by the
    number of rows it took."""
    from entropy_coders_tpu_torch.ops import crc as K
    from entropy_coders_tpu_torch.ops import pl_coder as PL

    calls = []

    def counted(rows, tail=None):
        calls.append(rows.shape[0])
        return K.crc32_blocks(rows, tail)

    monkeypatch.setattr(F, "crc32_blocks", counted)
    monkeypatch.setattr(PL, "crc32_blocks", counted)
    return calls


@pytest.mark.parametrize("ranks", [1, 2, 3])
@pytest.mark.parametrize("checksum", [True, False], ids=["crc", "no_crc"])
def test_one_crc_launch_a_share_a_call(crc_calls, ranks, checksum):
    """On a FLAG_CRC frame, compress checksums each share of the full
    blocks once and decompress each share of a per-lane group once (one
    chunk a share at this size); a frame without the flag calls no crc.
    On the CPU the wrapper runs the plain version: CRC_LAUNCHES stays."""
    from entropy_coders_tpu_torch.ops import crc as K

    data = gen_sequence(0.2, 6 * 4096 + 777, seed=62)
    before = K.CRC_LAUNCHES
    frame = F.compress(data, block_size=4096, k=128, lanes=True,
                       checksum=checksum, **_on_ranks(ranks))
    shares = [len(s) for s in np.array_split(np.arange(6), ranks)]
    assert crc_calls == (shares if checksum else [])
    crc_calls.clear()
    assert F.decompress(frame, **_on_ranks(ranks)) == data.tobytes()
    assert crc_calls == (shares if checksum else [])
    assert K.CRC_LAUNCHES == before

"""The port's device-side lane repack (entropy_coders_tpu_torch.ops.
device_repack) against the JAX package's (entropy_coders_tpu.ops.
device_repack, run on the CPU as tests/test_device_repack.py runs it), the
JAX package's host ``lane_*`` entries and the port's C++ host library, on
the CPU (the plain PyTorch versions; the CUDA kernels D1/D2 run only on the
card, where chip_smoke.py holds them against these). Then the container's
device-repack route (``frame._DEVICE_REPACK``), driven on ``device="cpu"``
through the plain versions: golden frames, the JAX package's frames, range
decodes and the corrupt-input cases of tests/test_torch_frame.py.

Tolerance: exact. Inputs come from a numpy seed; payloads are compared byte
for byte, words element for element, golden frames by sha256."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu import frame as JF  # noqa: E402
from entropy_coders_tpu.ops import device_repack as JDR  # noqa: E402
from entropy_coders_tpu.ops import pl_coder as JPL  # noqa: E402
from entropy_coders_tpu_torch import frame as F  # noqa: E402
from entropy_coders_tpu_torch import native  # noqa: E402
from entropy_coders_tpu_torch.ops import device_repack as DR  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import to_device, to_numpy  # noqa: E402
from tests import test_torch_frame as TFR  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402
from tests.data.generate_golden import make_input, make_mixed  # noqa: E402

GOLDEN = Path(__file__).parent / "data" / "golden"


def rand_lanes(seed, k, lo, hi, B=None, guard=False):
    """Lane words and sizes as tests/test_device_repack.py makes them
    (W = the longest lane's words + 2; bits past a lane's size zero), for
    one block or, with ``B``, a batch. ``guard`` sets the bits between a
    lane's size and the end of its last word at random (guard bits)."""
    rng = np.random.default_rng(seed)
    n = 1 if B is None else B
    sizes = rng.integers(lo, hi, (n, k)).astype(np.int32)
    W = int((sizes.max() + 31) // 32) + 2
    words = rng.integers(0, 1 << 32, (n, W, k), dtype=np.uint64).astype(
        np.uint32)
    rem = sizes[:, None, :] - 32 * np.arange(W)[None, :, None]
    if guard:
        words &= np.where(rem > 0, 0xFFFFFFFF, 0).astype(np.uint32)
    else:
        words &= np.where(rem >= 32, 0xFFFFFFFF,
                          (1 << np.clip(rem, 0, 31)) - 1).astype(np.uint32)
    if B is None:
        return words[0], sizes[0], W
    return words, sizes, W


# --- the JAX names: one block, bit-packed ------------------------------------------

JAX_CASES = [(128, 8, 200), (256, 9, 3000), (512, 33, 64), (128, 5, 6)]


@pytest.mark.parametrize("k,lo,hi", JAX_CASES)
def test_merge_split_bits_device_equal_jax(k, lo, hi):
    words, sizes, W = rand_lanes(k + lo, k, lo, hi)
    total = int(sizes.sum())
    OW = (total + 31) // 32 + 1
    got = DR.merge_bits_device(to_device(words, "cpu"),
                               torch.from_numpy(sizes), W=W, OW=OW)
    assert got.dtype == torch.uint32 and got.shape == (OW,)
    want = np.asarray(JDR.merge_bits_device(words, sizes, W=W, OW=OW))
    assert (to_numpy(got) == want).all()
    assert to_numpy(got).tobytes()[: (total + 7) // 8] == \
        JPL.lane_merge_bits(words, sizes)
    back = DR.split_bits_device(got, torch.from_numpy(sizes), W=W)
    assert (to_numpy(back) == words).all()
    assert (to_numpy(back)
            == np.asarray(JDR.split_bits_device(want, sizes, W=W))).all()


def test_merge_bits_device_masks_guard_bits():
    """Bits at and above a lane's size never reach the packed stream, as
    ``_masked_words`` promises in the JAX module."""
    words, sizes, W = rand_lanes(3, 128, 40, 200, guard=True)
    clean = words & np.where(
        sizes[None, :] - 32 * np.arange(W)[:, None] >= 32, 0xFFFFFFFF,
        (1 << np.clip(sizes[None, :] - 32 * np.arange(W)[:, None], 0, 31))
        - 1).astype(np.uint32)
    OW = (int(sizes.sum()) + 31) // 32 + 1
    st = torch.from_numpy(sizes)
    a = DR.merge_bits_device(to_device(words, "cpu"), st, W=W, OW=OW)
    b = DR.merge_bits_device(to_device(clean, "cpu"), st, W=W, OW=OW)
    assert (to_numpy(a) == to_numpy(b)).all()
    assert (to_numpy(a)
            == np.asarray(JDR.merge_bits_device(words, sizes, W=W, OW=OW))).all()


# --- the batched entries against the C++ library: both wire forms -------------------


def _merge(words, sizes, pack):
    flat, offs = DR.lane_merge_device(to_device(words, "cpu"),
                                      torch.from_numpy(sizes), pack_bits=pack)
    flat, offs = flat.numpy(), offs.numpy()
    assert offs.dtype == np.int64 and len(offs) == len(sizes) + 1
    # only the payloads are promised, with the dead bits of their last
    # 4-byte word zero (the kernel leaves the rest of its bound unwritten)
    assert not flat[offs[-1]: -(-offs[-1] // 4) * 4].any()
    return [flat[offs[b]: offs[b + 1]].tobytes() for b in range(len(sizes))]


@pytest.mark.parametrize("pack", [False, True], ids=["bytes", "packed"])
@pytest.mark.parametrize("k,lo,hi", [(128, 0, 290), (384, 9, 3000),
                                     (1024, 32, 65)])
def test_batched_merge_split_equal_native(pack, k, lo, hi):
    words, sizes, W = rand_lanes(k + hi, k, lo, hi, B=3)
    # zero-size, one-bit and one-byte lanes, sizes on a word boundary
    sizes[0, :6] = [0, 1, 8, 32, 64, 32 * (W - 2)]
    words[0, :, :6] &= np.where(
        sizes[0, None, :6] - 32 * np.arange(W)[:, None] >= 32, 0xFFFFFFFF,
        (1 << np.clip(sizes[0, None, :6] - 32 * np.arange(W)[:, None], 0, 31))
        - 1).astype(np.uint32)
    ref = native.lane_merge_batch(words, sizes, pack)
    assert _merge(words, sizes, pack) == ref
    # split from inside a larger buffer, from an odd byte on
    pre = 5
    buf = b"\xff" * pre + b"".join(ref) + b"\xff" * 3
    offs = pre + np.concatenate([[0], np.cumsum([len(r) for r in ref])[:-1]])
    flat = DR.bytes_on(buf, 0, len(buf), "cpu")
    assert flat.numel() % 4 == 0 and bytes(flat[: len(buf)].numpy()) == buf
    got = DR.lane_split_device(flat, torch.from_numpy(offs),
                               torch.from_numpy(sizes), k=k, W=W + 3,
                               pack_bits=pack)
    assert got.dtype == torch.uint32 and got.shape == (3, W + 3, k)
    assert (to_numpy(got)
            == native.lane_split_batch(ref, sizes, k, W + 3, pack)).all()
    assert (to_numpy(got)[:, :W] == words).all()
    assert not to_numpy(got)[:, W:].any()


def test_guard_bits_pinned():
    """What the merges do with guard bits (bits between a lane's size and
    the end of its last word), equal to the C++ library's in both forms:
    the bit-packed merge drops them all; the byte-aligned merge copies a
    lane's last byte whole, so guard bits inside that byte reach the wire
    and those above it do not."""
    words, sizes, W = rand_lanes(11, 128, 40, 200, B=2, guard=True)
    clean = rand_lanes(11, 128, 40, 200, B=2)[0]
    assert (words != clean).any()
    for pack in (False, True):
        assert _merge(words, sizes, pack) == \
            native.lane_merge_batch(words, sizes, pack)
    assert _merge(words, sizes, True) == _merge(clean, sizes, True)
    assert _merge(words, sizes, False) != _merge(clean, sizes, False)
    # the byte-aligned split keeps the last byte whole too
    ref = native.lane_merge_batch(words, sizes, False)
    flat = DR.bytes_on(b"".join(ref), 0, sum(map(len, ref)), "cpu")
    offs = np.concatenate([[0], np.cumsum([len(r) for r in ref])[:-1]])
    got = DR.lane_split_device(flat, torch.from_numpy(offs),
                               torch.from_numpy(sizes), k=128, W=W)
    assert (to_numpy(got) == native.lane_split_batch(ref, sizes, 128, W)).all()


# --- the offsets as the kernels take them, in plain PyTorch --------------------------


def _sizes_cases():
    rng = np.random.default_rng(77)
    yield "mixed", rng.integers(0, 3000, (3, 256)).astype(np.int32)
    five = np.full((4, 128), 5, np.int32)  # 5-bit lanes (L=5)
    five[1, ::3] = 0
    yield "five_bit", five
    edge = rng.integers(1, 2000, (2, 128)).astype(np.int32)
    edge[0, :4] = [32, 1024, 1056, 0]  # a word, a 32-row tile, one past
    edge[1] = 0  # a block without payload
    yield "edges", edge
    yield "default_launch", rng.integers(5, 1200, (512, 1024)).astype(np.int32)


@pytest.mark.parametrize("pack", [False, True], ids=["bytes", "packed"])
@pytest.mark.parametrize("name,sizes", list(_sizes_cases()),
                         ids=[c[0] for c in _sizes_cases()])
@pytest.mark.parametrize("framed", [False, True], ids=["merge", "split"])
def test_kernel_offsets_model(pack, name, sizes, framed):
    """The kernels' formulation of the offsets (group sums, their scan, a
    shuffle scan within a group, block bytes) equals ``lane_offsets`` and
    the C++ library's payload lengths, for both wire forms, laid end to end
    (the merge) or at given block offsets (the split)."""
    st = torch.from_numpy(sizes)
    B, k = sizes.shape
    boffs = None
    if framed:
        boffs = torch.from_numpy((np.arange(B) * 7919 + (1 << 33))
                                 .astype(np.int64))
    bit_off, offs, goff, nbytes = DR.kernel_offsets_ref(st, pack, boffs)
    want_off, want_offs = DR.lane_offsets(st, pack, boffs)
    assert bit_off.dtype == torch.int64 and torch.equal(bit_off, want_off)
    assert goff.shape == (B, k // 32) and nbytes.shape == (B,)
    lens = [len(p) for p in native.lane_merge_batch(
        np.zeros((B, 1, k), np.uint32), sizes, pack)]
    assert nbytes.tolist() == lens
    assert torch.equal(goff, bit_off[:, ::32] - bit_off[:, :1])
    if framed:
        assert offs is None and want_offs is None
        assert torch.equal(bit_off[:, 0], boffs << 3)
    else:
        assert torch.equal(offs, want_offs)
        assert offs.tolist() == [0, *np.cumsum(lens).tolist()]


@pytest.mark.parametrize("pack", [False, True], ids=["bytes", "packed"])
@pytest.mark.parametrize("case", ["five_bit", "tile_edges", "default_launch"])
def test_merge_split_edge_lanes_equal_native(pack, case):
    """Cases the kernels' word ownership turns on: one wire word spanning
    three or more lanes (5-bit lanes, some empty), lanes that end exactly
    on a word and on a 32-row tile, a block without payload, and B=512
    blocks at k=1024 (the default launch's shape)."""
    if case == "five_bit":
        words, sizes, W = rand_lanes(5, 128, 5, 6, B=4)
        sizes[1, ::3] = 0
        sizes[2, :10] = [0, 0, 0, 5, 0, 0, 1, 5, 0, 0]
    elif case == "tile_edges":
        words, sizes, W = rand_lanes(9, 128, 900, 1100, B=3)
        sizes[0, :6] = [1024, 1056, 32, 1024, 64, 1023]
        sizes[1] = 0
    else:
        words, sizes, W = rand_lanes(12, 1024, 5, 90, B=512)
    rem = sizes[:, None, :] - 32 * np.arange(W)[None, :, None]
    words &= np.where(rem >= 32, 0xFFFFFFFF,
                      (1 << np.clip(rem, 0, 31)) - 1).astype(np.uint32)
    ref = native.lane_merge_batch(words, sizes, pack)
    assert _merge(words, sizes, pack) == ref
    k = sizes.shape[1]
    buf = b"\x00" * 3 + b"".join(ref) + b"\x01"
    offs = 3 + np.concatenate([[0], np.cumsum([len(r) for r in ref])[:-1]])
    got = DR.lane_split_device(DR.bytes_on(buf, 0, len(buf), "cpu"),
                               torch.from_numpy(offs), torch.from_numpy(sizes),
                               k=k, W=W + 1, pack_bits=pack)
    assert (to_numpy(got) == native.lane_split_batch(ref, sizes, k, W + 1,
                                                     pack)).all()
    assert (to_numpy(got)[:, :W] == words).all()


def test_offsets_are_64_bit():
    """A block past 2^32 bits of the flat buffer keeps exact offsets."""
    sizes = torch.full((2, 128), 100, dtype=torch.int32)
    far = torch.tensor([1 << 33, (1 << 33) + 13 * 128], dtype=torch.int64)
    off, none = DR.lane_offsets(sizes, False, far)
    assert none is None and off.dtype == torch.int64
    assert int(off[0, 0]) == 1 << 36 and int(off[1, 5]) == (far[1] + 65) * 8
    off, offs = DR.lane_offsets(sizes, True)
    assert offs.tolist() == [0, 1600, 3200]
    assert int(off[1, 1]) == 1600 * 8 + 100


def test_wrappers_check_inputs():
    words, sizes, W = rand_lanes(5, 128, 8, 100, B=2)
    w, s = to_device(words, "cpu"), torch.from_numpy(sizes)
    with pytest.raises(ValueError):
        DR.lane_merge_device(w[0], s)
    with pytest.raises(ValueError):
        DR.lane_merge_device(w, s.to(torch.int64))
    with pytest.raises(ValueError):
        DR.lane_merge_device(w[:, :, :100].contiguous(), s[:, :100].contiguous())
    flat = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError):
        DR.lane_split_device(flat.to(torch.int32), [0, 0], s, k=128, W=W)
    with pytest.raises(ValueError):
        DR.lane_split_device(flat, [0], s, k=128, W=W)


def test_cpu_tensors_launch_no_kernel():
    before = DR.MERGE_LAUNCHES, DR.SPLIT_LAUNCHES
    words, sizes, W = rand_lanes(6, 128, 8, 100, B=1)
    flat, offs = DR.lane_merge_device(to_device(words, "cpu"),
                                      torch.from_numpy(sizes))
    DR.lane_split_device(flat, offs[:-1], torch.from_numpy(sizes), k=128, W=W)
    assert (DR.MERGE_LAUNCHES, DR.SPLIT_LAUNCHES) == before


# --- the single-block host entries against the JAX package's ------------------------


@pytest.mark.parametrize("k,lo,hi", JAX_CASES)
def test_single_block_entries_equal_jax(k, lo, hi):
    words, sizes, W = rand_lanes(2 * k + lo, k, lo, hi)
    merged = PL.lane_merge(words, sizes)
    assert merged == JPL.lane_merge(words, sizes)
    packed = PL.lane_merge_bits(words, sizes)
    assert packed == JPL.lane_merge_bits(words, sizes)
    for port, jax_fn, payload in ((PL.lane_split, JPL.lane_split, merged),
                                  (PL.lane_split_bits, JPL.lane_split_bits,
                                   packed)):
        got, got_w = port(payload + b"tail", sizes, k)
        want, want_w = jax_fn(payload + b"tail", sizes, k)
        assert got_w == want_w == W
        assert got.dtype == np.uint32 and (got == want).all()
        assert (got == words).all()


def test_single_block_entries_raise_like_jax():
    words, sizes, W = rand_lanes(9, 128, 8, 200)
    for port, jax_fn, payload, msg in (
            (PL.lane_split, JPL.lane_split, PL.lane_merge(words, sizes),
             "lane payload too short"),
            (PL.lane_split_bits, JPL.lane_split_bits,
             PL.lane_merge_bits(words, sizes),
             "packed lane payload too short")):
        for fn in (port, jax_fn):
            with pytest.raises(ValueError, match=msg):
                fn(payload[:-1], sizes, 128)
        # a wrong sizes shape: the JAX entries assert, the port raises
        with pytest.raises(AssertionError):
            jax_fn(payload, sizes[:-1], 128)
        with pytest.raises(ValueError, match="shape"):
            port(payload, sizes[:-1], 128)


# --- the container's device-repack route, on the CPU --------------------------------


@pytest.fixture
def device_route(monkeypatch):
    """The container takes the device repack (through the plain versions,
    on ``device="cpu"``); yields the calls it made."""
    calls = {"merge": 0, "split": 0, "spans": []}
    monkeypatch.setattr(F, "_DEVICE_REPACK", True)
    real = DR.lane_merge_device, DR.lane_split_device, DR.bytes_on

    def merge(*a, **kw):
        calls["merge"] += 1
        return real[0](*a, **kw)

    def split(*a, **kw):
        calls["split"] += 1
        return real[1](*a, **kw)

    def bytes_on(buffer, lo, hi, device, **kw):
        calls["spans"].append((lo, hi))
        return real[2](buffer, lo, hi, device, **kw)

    monkeypatch.setattr(DR, "lane_merge_device", merge)
    monkeypatch.setattr(DR, "lane_split_device", split)
    monkeypatch.setattr(DR, "bytes_on", bytes_on)
    return calls


@pytest.mark.parametrize("case", TFR.FRAME_CASES,
                         ids=[c["name"] for c in TFR.FRAME_CASES])
def test_device_route_reproduces_golden(case, device_route):
    spec = case["input"]
    data = (make_mixed(spec["size"], spec["seed"])
            if spec["kind"] == "mixed_rle_raw" else make_input(spec))
    kw = {kk: case[kk] for kk in TFR.KNOBS if kk in case}
    frame = F.compress(data, device="cpu", **kw)
    assert hashlib.sha256(frame).hexdigest() == case["sha256"]
    golden = (GOLDEN / case["file"]).read_bytes()
    assert F.decompress(golden, device="cpu") == data.tobytes()
    if kw.get("lanes"):
        assert device_route["merge"] > 0 and device_route["split"] > 0


def test_golden_manifest_has_five_frames():
    assert len(TFR.FRAME_CASES) >= 5
    names = {c["name"] for c in json.loads(
        (GOLDEN / "manifest.json").read_text())}
    assert {c["name"] for c in TFR.FRAME_CASES} <= names


@pytest.mark.parametrize("name", list(TFR.JAX_CONFIGS))
def test_device_route_matches_jax(name, device_route):
    size, kw = TFR.JAX_CONFIGS[name]
    data = gen_sequence(0.2, size, seed=len(name) + 50)
    jframe = JF.compress(data, lanes=True, interpret=True, **kw)
    assert F.compress(data, device="cpu", lanes=True, **kw) == jframe
    assert F.decompress(jframe, device="cpu") == data.tobytes()
    assert device_route["merge"] > 0 and device_route["split"] > 0


@pytest.mark.parametrize("bit_pack", [False, True], ids=["bytes", "packed"])
def test_device_route_equals_host_route(bit_pack, monkeypatch):
    """Several table-log groups and chunks of a few blocks: both routes
    write the same frame and read it back."""
    data = np.concatenate([gen_sequence(p, 6 * 4096, seed=int(p * 100))
                           for p in (0.05, 0.2, 0.6)])
    kw = dict(block_size=4096, k=128, lanes=True, bit_pack=bit_pack)
    monkeypatch.setattr(F, "_CHUNK_RAW", 3 * 4096)
    frames = []
    for route in (False, True):
        monkeypatch.setattr(F, "_DEVICE_REPACK", route)
        frames.append(F.compress(data, device="cpu", **kw))
        for other in frames:
            assert F.decompress(other, device="cpu") == data.tobytes()
    assert frames[0] == frames[1]
    pf = F._parse_frame(frames[0])
    assert (pf.modes == F.MODE_FSE_PL).all()


@pytest.mark.parametrize("start,length", [(0, None), (100, 5000),
                                          (4096, 4096), (12000, 411),
                                          (12288, 0)])
def test_device_route_range_decode(start, length, device_route):
    """A range decode copies only the span of its blocks' payloads."""
    data = gen_sequence(0.2, 3 * 4096 + 123, seed=41)
    frame = F.compress(data, device="cpu", block_size=4096, k=128, lanes=True)
    end = len(data) if length is None else start + length
    device_route["spans"].clear()
    got = F.decompress(frame, device="cpu", start=start, length=length)
    assert got == data[start:end].tobytes()
    pf = F._parse_frame(frame)
    blocks = [i for i in range(pf.n_blocks)
              if i * 4096 < end and (i + 1) * 4096 > start
              and pf.modes[i] == F.MODE_FSE_PL] if end > start else []
    if not blocks:
        assert device_route["spans"] == []
        return
    (lo, hi), = device_route["spans"]
    assert int(pf.offs[blocks[0]]) < lo
    assert hi == int(pf.offs[blocks[-1]] + pf.lens[blocks[-1]])


def test_device_route_decodes_mmap_and_memoryview(tmp_path, device_route):
    """The frame may be an ``mmap`` (``stream``) or a memoryview
    (``checkpoint``): read-only buffers, copied without a warning."""
    import mmap
    import warnings

    data = gen_sequence(0.2, 2 * 4096, seed=47)
    frame = F.compress(data, device="cpu", block_size=4096, k=128, lanes=True)
    path = tmp_path / "f.fset"
    path.write_bytes(b"head" + frame)
    with open(path, "rb") as fh, \
            mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm, \
            warnings.catch_warnings():
        warnings.simplefilter("error")
        mv = memoryview(mm)[4:]
        assert F.decompress(mv, device="cpu") == data.tobytes()
        mv.release()
    assert device_route["split"] > 0


def _corrupt_cases():
    pl = [TFR.test_bad_magic_and_version, TFR.test_truncated_frame,
          TFR.test_lane_sizes_tampered,
          TFR.test_lane_sizes_amplification_bounded]
    return ([(fn, "pl_frame") for fn in pl]
            + [(TFR.test_random_corruption_raises_value_error_only, False),
               (TFR.test_random_corruption_raises_value_error_only, True),
               (TFR.test_checksum_catches_corruption, None)])


@pytest.mark.parametrize(
    "fn,arg", _corrupt_cases(),
    ids=[f"{fn.__name__[5:]}-{arg}" for fn, arg in _corrupt_cases()])
def test_corrupt_inputs_on_device_route(fn, arg, device_route):
    """The corrupt-input cases of tests/test_torch_frame.py with the
    container on the device-repack route: ValueError and nothing else."""
    if arg == "pl_frame":
        data = gen_sequence(0.2, 3 * 4096 + 123, seed=41)
        fn((data, F.compress(data, device="cpu", block_size=4096, k=128,
                             lanes=True)))
    elif arg is None:
        fn()
    else:
        fn(arg)
    assert device_route["merge"] > 0


# --- what the card checks, on synthetic inputs ----------------------------------------


@pytest.mark.parametrize("ops,ok", [
    ({"scan_kernel(int)": {"calls": 1.0, "us": 3.0},
      "merge_kernel(int)": {"calls": 1.0, "us": 30.0}}, True),
    ({"merge_kernel(int)": {"calls": 1.0, "us": 30.0}}, True),
    ({"scan_kernel(int)": {"calls": 2.0, "us": 3.0},
      "merge_kernel(int)": {"calls": 1.0, "us": 30.0}}, False),
    ({"Memset (Device)": {"calls": 1.0, "us": 20.0},
      "merge_kernel(int)": {"calls": 1.0, "us": 30.0}}, False),
    ({"void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor": {"calls": 1.0, "us": 20.0},
      "merge_kernel(int)": {"calls": 1.0, "us": 30.0}}, False),
    ({"Memcpy HtoD (Pageable -> Device)": {"calls": 1.0, "us": 2.0}}, False),
], ids=["two_kernels", "one_kernel", "three_kernels", "memset", "fill",
        "no_kernel"])
def test_device_ops_rule(ops, ok):
    """The rule chip_smoke.py holds a repack call's profiler window to: at
    most two kernels, at least one, no memset and no fill; ``kernel_ms``
    sums the kernels' device time and leaves the copies out."""
    from entropy_coders_tpu_torch.tools import device_host as DH

    if ok:
        assert DH.check_ops(ops, "case")["kernels"] == sum(
            o["calls"] for o in ops.values())
        assert DH.kernel_ms(ops) == pytest.approx(
            sum(o["us"] for o in ops.values()) / 1e3)
        assert DH.kernel_ms(ops, "merge") == pytest.approx(0.030)
    else:
        with pytest.raises(AssertionError):
            DH.check_ops(ops, "case")


@pytest.mark.parametrize("count,us,calls,want", [
    (20, 600.0, 10, {"calls": 2, "seen": 2.0, "us": 60.0}),
    (18, 540.0, 10, {"calls": 2, "seen": 1.8, "us": 60.0}),
    (7, 210.0, 10, {"calls": 1, "seen": 0.7, "us": 30.0}),
    (1, 30.0, 10, {"calls": 1, "seen": 0.1, "us": 30.0}),
], ids=["all_seen", "two_missed", "three_missed", "one_seen"])
def test_op_row_is_unbiased_by_missed_events(count, us, calls, want):
    """A profiler window that misses some of a kernel's events still gives
    its launches a call and its device time a call."""
    from entropy_coders_tpu_torch.tools import device_host as DH

    got = DH.op_row(count, us, calls)
    assert got["calls"] == want["calls"]
    assert got["seen"] == pytest.approx(want["seen"])
    assert got["us"] == pytest.approx(want["us"])


def test_old_repack_interface_is_read_from_its_source():
    """``device_host --old`` builds another commit's ``repack.cu``: the
    first design's launchers take the lane offsets, the current ones the
    outputs and scratch."""
    from pathlib import Path

    from entropy_coders_tpu_torch.tools import device_host as DH

    first = ('extern "C" int ect_lane_merge(const void* words, const void* '
             'sizes,\n    const void* bit_off, void* out, long long n_out, '
             'int B,\n    int W, int k, int pack, void* stream) {\n')
    assert DH.takes_bit_offsets(first)
    src = (Path(DR.__file__).resolve().parent.parent / "csrc" /
           "repack.cu").read_text()
    assert not DH.takes_bit_offsets(src)

"""The benchmark's size-parity configuration (``ect_bench/configs/
parity_128m.json``: k=8192, L=11, bit-packed lanes, a crc32 a block) on the
CPU at a small size: its knobs with 32 KiB blocks and k=256, on the
configuration's own seeded data. The port's frame carries both flags, the
benchmark's plain reference (``ect_bench.reference``, which imports nothing
of the port) finds no block wrong, and the decompress gives the bytes back.
A planted fault, one byte of one block's crc flipped, makes the port's
decompress raise ValueError and the reference report that block.
Tolerance: exact."""

import struct

import pytest

pytest.importorskip("torch")

from ect_bench import data, harness, registry  # noqa: E402
from ect_bench.reference import check_frame  # noqa: E402
from entropy_coders_tpu_torch import frame as F  # noqa: E402

BS, K = 32768, 256
SEED = 2**33 + 22
SIZES = {"whole": 6 * BS, "tail": 6 * BS + 5000}
HEADER = len(F.MAGIC) + struct.calcsize("<BBHIQI")


def _cell(size: int):
    """The parity configuration cut to ``size`` bytes, 32 KiB blocks and
    k=256: (input, the port's knobs, the reference's knobs)."""
    cfg = registry.config("parity_128m")
    cfg = dict(cfg, size=size,
               knobs=dict(cfg["knobs"], block_size=BS, k=K))
    x = data.make(cfg["data"], size, SEED)
    return x, harness.port_kwargs(cfg["knobs"]), harness.knobs_of(cfg)


@pytest.fixture(scope="module", params=sorted(SIZES))
def parity(request):
    x, kw, knobs = _cell(SIZES[request.param])
    return x, F.compress(x, device="cpu", **kw), knobs


def test_the_knobs_are_the_parity_point():
    knobs = registry.config("parity_128m")["knobs"]
    assert (knobs["block_size"], knobs["k"], knobs["table_log"]) == \
        (16 << 20, 8192, 11)
    assert knobs["lanes"] and knobs["bit_pack"] and knobs["checksum"]


def test_the_frame_carries_both_flags_and_packed_lanes(parity):
    x, frame, _ = parity
    pf = F._parse_frame(frame)
    assert pf.packed and pf.crcs is not None and len(pf.crcs) == pf.n_blocks
    full = len(x) // BS
    assert (pf.modes[:full] == F.MODE_FSE_PL).all()


def test_the_reference_finds_no_block_wrong(parity):
    x, frame, knobs = parity
    rep = check_frame(frame, x, knobs)
    assert rep.wrong == 0, (rep.frame_wrong, rep.blocks_wrong)
    assert rep.blocks_checked == -(-len(x) // BS)


def test_the_decompress_gives_the_bytes_back(parity):
    x, frame, _ = parity
    assert F.decompress(frame, device="cpu") == x.tobytes()


@pytest.mark.parametrize("block,byte", [(0, 0), (3, 2), (-1, 3)])
def test_a_flipped_crc_byte_is_caught_by_both(parity, block, byte):
    x, frame, knobs = parity
    pf = F._parse_frame(frame)
    block %= pf.n_blocks
    # the crc table follows the frame's header and its block table of
    # n_blocks u32 entries (no shared table here)
    crc_at = HEADER + 4 * pf.n_blocks + 4 * block
    assert frame[crc_at: crc_at + 4] == struct.pack("<I", int(pf.crcs[block]))
    bad = bytearray(frame)
    bad[crc_at + byte] ^= 0x20
    with pytest.raises(ValueError, match=f"block {block}: crc mismatch"):
        F.decompress(bytes(bad), device="cpu")
    rep = check_frame(bytes(bad), x, knobs)
    assert rep.blocks_wrong == [(block, "crc")] and not rep.frame_wrong


def test_every_crc_is_made_on_the_device_at_the_parity_point(parity):
    """At the parity point each block's crc is computed where the block
    work runs (``ops.crc``): every full block on compress, every per-lane
    block on decompress; only a ragged tail block, never a row there, is
    checksummed on the host when compressing. So ``crc.<op>.device`` over
    ``crc.<op>`` is 1.0 in the cell, which has no tail."""
    from entropy_coders_tpu_torch.utils import profiling

    x, _, _ = parity
    _, kw, _ = _cell(len(x))
    got = {}
    for op in ("compress", "decompress"):
        before = dict(profiling.counters)
        if op == "compress":
            frame = F.compress(x, device="cpu", **kw)
        else:
            assert F.decompress(frame, device="cpu") == x.tobytes()
        got[op] = [profiling.counters.get(key, 0) - before.get(key, 0)
                   for key in (f"crc.{op}", f"crc.{op}.device")]
    full = len(x) // BS * BS
    pf = F._parse_frame(frame)
    assert (pf.modes[: len(x) // BS] == F.MODE_FSE_PL).all()
    # the 5,000-byte tail (not lane-divisible) is MODE_FSE: on the host
    per_lane = full + (len(x) - full) * int(pf.modes[-1] == F.MODE_FSE_PL)
    assert got["compress"] == [len(x), full]
    assert got["decompress"] == [len(x), per_lane]

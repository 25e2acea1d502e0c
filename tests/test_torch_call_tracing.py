"""What the port marks of its own calls, on the CPU: every public
``frame.compress``/``decompress`` call is one ``ect.<op>`` range that holds
every other ``ect.*`` range of the call; the table build is a stage of the
direction it serves; on a mesh each share's dispatch and drain is a range
named for its rank, one a rank a round, in rank order; and the counters of
fresh host bytes (``utils.profiling.counters``) equal the bytes their sites
allocate, with ``tracemalloc``'s peak during a call never above the counted
bytes plus the call's input, so that a site left uncounted shows.

Frames that carry FLAG_CRC or FLAG_PACKED mark that work too, and only
they: each crc pass is a range ``ect.<op>.crc`` and each lane-size table a
range ``ect.<op>.size_table``, and the counters ``crc.<op>`` (the raw bytes
checksummed), ``crc.<op>.device`` (those of them checksummed where the
block work ran: every full block on compress, every per-lane block on
decompress) and ``size_table.<op>.coded`` / ``.raw`` (the per-lane blocks
by the kind of their size table) hold exactly.

The mesh is ``torch.device("cpu")`` n times (virtual ranks, the plain
versions), on both repack routes. Tolerance: exact."""

import contextlib
import functools
import hashlib
import json
import struct
import sys
import tracemalloc
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import record_function  # noqa: E402

from entropy_coders_tpu_torch import frame as F  # noqa: E402
from entropy_coders_tpu_torch import mesh as M  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.ops.coder import encode_layout  # noqa: E402
from entropy_coders_tpu_torch.parallel import block_sharding  # noqa: E402
from entropy_coders_tpu_torch.utils import profiling  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402

BS = 4096
K = 128


def _data(kind: str, bs: int) -> np.ndarray:
    body = gen_sequence(0.2, 6 * bs, seed=3)
    if kind == "fse_tail":
        return np.concatenate([body, gen_sequence(0.2, 1000, seed=4)])
    if kind == "raw_tail":
        return np.concatenate([body, gen_sequence(0.2, 5, seed=4)])
    if kind == "rle":
        return np.concatenate([body[:2 * bs], np.full(bs, 7, np.uint8),
                               body[2 * bs:]])
    if kind == "groups":  # two table-log groups under the fast policy
        return np.concatenate([gen_sequence(p, 4 * bs, seed=i)
                               for i, p in enumerate((0.05, 0.3, 0.9))])
    if kind == "raw_fallback":
        rng = np.random.default_rng(5)
        return np.concatenate([body[:bs], rng.integers(0, 256, bs, np.uint8),
                               body[bs:]])
    return body


# case: (data kind, compress knobs, ranks, decompress knobs, device repack)
CASES = {
    "lanes": ("lanes", dict(lanes=True), 1, {}, None),
    "lanes_device_repack": ("lanes", dict(lanes=True, checksum=True), 1, {},
                            True),
    "fse": ("lanes", dict(lanes=False), 1, {}, None),
    "fse_tail": ("fse_tail", dict(lanes=True), 1, {}, None),
    "raw_tail": ("raw_tail", dict(lanes=True), 1, {}, None),
    "rle": ("rle", dict(lanes=True), 1, {}, None),
    "raw_fallback": ("raw_fallback", dict(lanes=False), 1, {}, None),
    "shared": ("fse_tail", dict(lanes=True, shared_table=True), 1, {}, None),
    "bytes_in": ("fse_tail", dict(lanes=True, as_bytes=True), 1, {}, None),
    "out": ("lanes", dict(lanes=True), 1, dict(out=True), None),
    "range": ("fse_tail", dict(lanes=True), 1,
              dict(start=17, length=3), None),  # in blocks, from block 1
    "mesh2": ("fse_tail", dict(lanes=True), 2, {}, None),
    "mesh4_fse": ("lanes", dict(lanes=False), 4, {}, None),
    "mesh4_device_repack": ("lanes", dict(lanes=True), 4, {}, True),
    # FLAG_PACKED and FLAG_CRC together: the k=2 size-table codec and the
    # crc passes, on both repack routes and over a range
    "packed_crc": ("lanes", dict(lanes=True, bit_pack=True, checksum=True),
                   1, {}, None),
    "packed_crc_device_repack": ("lanes", dict(lanes=True, bit_pack=True,
                                               checksum=True), 1, {}, True),
    "packed_crc_range": ("fse_tail", dict(lanes=True, bit_pack=True,
                                          checksum=True), 1,
                         dict(start=17, length=3), None),
    # FLAG_CRC over blocks that are checksummed on the host on decompress
    # (RLE, RAW, a MODE_FSE tail) beside per-lane ones, on a mesh too
    "crc_rle": ("rle", dict(lanes=True, checksum=True), 1, {}, None),
    "crc_fse_raw_fallback": ("raw_fallback", dict(lanes=False,
                                                  checksum=True), 1, {}, None),
    "crc_fse_tail_mesh3": ("fse_tail", dict(lanes=True, checksum=True), 3,
                           {}, None),
}


def _place(n: int) -> dict:
    if n == 1:
        return dict(device="cpu")
    return dict(sharding=block_sharding((torch.device("cpu"),) * n))


def _build(name: str, bs: int, monkeypatch):
    """Case ``name`` at block size ``bs``: (data, what compress is given,
    compress knobs, decompress knobs, ranks, the repack switch)."""
    kind, ckw, n, dkw, repack = CASES[name]
    monkeypatch.setattr(F, "_DEVICE_REPACK", repack)
    ckw = dict(ckw)
    as_bytes = ckw.pop("as_bytes", False)
    if "start" in dkw:
        dkw = dict(start=bs + dkw["start"], length=dkw["length"] * bs)
    data = _data(kind, bs)
    return (data, data.tobytes() if as_bytes else data,
            dict(block_size=bs, k=K, **ckw, **_place(n)), dkw, n, repack)


@pytest.fixture
def case(request, monkeypatch):
    return _build(request.param, BS, monkeypatch)


def _decompress(frame, dkw, n, out: bytearray):
    """Decompress as case knobs ``dkw`` say: into ``out`` with ``out``."""
    kw = dict(dkw)
    if kw.pop("out", False):
        assert F.decompress(frame, out=out, **_place(n), **kw) == len(out)
        return out
    return F.decompress(frame, **_place(n), **kw)


def _counted(before: dict, op: str) -> Counter:
    """The ``host_bytes.<op>.*`` counters made since ``before``, by site,
    and the calls of ``op``."""
    now = profiling.counters
    got = Counter()
    for key, v in now.items():
        d = v - before.get(key, 0)
        if d and (key.startswith(f"host_bytes.{op}.")
                  or key == f"calls.{op}"):
            got[key.rsplit(".", 1)[1] if key.startswith("host") else "calls"] \
                = d
    return got


# --- the ranges --------------------------------------------------------------


class Ranges:
    """Stands in for ``record_function``: logs each range's entry and exit."""

    def __init__(self):
        self.log = []

    @contextlib.contextmanager
    def __call__(self, name):
        self.log.append(("enter", name))
        try:
            yield
        finally:
            self.log.append(("exit", name))

    def entered(self, prefix=""):
        return [n for what, n in self.log
                if what == "enter" and n.startswith(prefix)]


@pytest.fixture
def ranges(monkeypatch):
    r = Ranges()
    monkeypatch.setattr(F, "_stage", r)
    monkeypatch.setattr(M, "_stage", r)
    monkeypatch.setattr(PL, "record_function", r)
    return r


def _one_call_range(r: Ranges, op: str):
    assert r.entered(f"ect.{op}") and r.entered("ect.")[0] == f"ect.{op}"
    assert r.entered().count(f"ect.{op}") == 1
    # the call's range is opened first and closed last: every other range
    # of the call lies inside it
    assert r.log[0] == ("enter", f"ect.{op}")
    assert r.log[-1] == ("exit", f"ect.{op}")
    others = [n for n in r.entered() if n != f"ect.{op}"]
    assert others and all(n.startswith(f"ect.{op}.") for n in others)
    assert "ect.tables" not in r.entered()


@pytest.mark.parametrize("case", sorted(CASES), indirect=True)
def test_one_call_range_holds_every_range_of_the_call(case, ranges):
    data, given, ckw, dkw, n, _ = case
    frame = F.compress(given, **ckw)
    _one_call_range(ranges, "compress")
    assert "ect.compress.tables" in ranges.entered()
    ranges.log.clear()
    got = _decompress(frame, dkw, n, bytearray(len(data)))
    _one_call_range(ranges, "decompress")
    assert "ect.decompress.tables" in ranges.entered()
    lo = dkw.get("start", 0)
    assert got == data[lo: lo + dkw.get("length", len(data))].tobytes()


def _rounds(names, prefix):
    """Ranks of the ``prefix<rank>`` ranges, in rounds of rising rank."""
    rounds = []
    for name in names:
        rank = int(name[len(prefix):])
        if not rounds or rank <= rounds[-1][-1]:
            rounds.append([])
        rounds[-1].append(rank)
    return rounds


@pytest.mark.parametrize("lanes", [True, False])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_share_ranges_one_a_rank_a_round_in_rank_order(ranges, n, lanes):
    """8 blocks of one table-log group, no tail: compress dispatches the
    h2d, the histograms and the group's encode a share at a time and drains
    the histograms and the encode; decompress dispatches and drains the
    group. Every round holds ranks 0..n-1 once, in order."""
    data = gen_sequence(0.2, 8 * BS, seed=9)
    frame = F.compress(data, block_size=BS, k=K, lanes=lanes, table_log=9,
                       **_place(n))
    every = list(range(n))
    for op, dispatch, drain in (("compress", 3, 2), ("decompress", 1, 1)):
        d = _rounds(ranges.entered(f"ect.{op}.share_dispatch."),
                    f"ect.{op}.share_dispatch.")
        c = _rounds(ranges.entered(f"ect.{op}.share_drain."),
                    f"ect.{op}.share_drain.")
        assert d == [every] * dispatch and c == [every] * drain, (op, d, c)
        ranges.log.clear()
        if op == "compress":
            assert F.decompress(frame, **_place(n)) == data.tobytes()


# --- the counters of fresh host bytes -------------------------------------------


def _payload(pf, i) -> bytes:
    sec = pf.section(i)
    return sec if pf.shared else F._read_block_header(sec)[2]


def _lane_sizes(pf, payload, k) -> tuple[np.ndarray, int]:
    """A per-lane payload's lane sizes in bits, and the bytes of its lane
    streams (past the size table, packed or not), read without the
    program's size-table functions."""
    if not pf.packed:
        return (np.frombuffer(payload[:2 * k], "<u2").astype(np.int32),
                len(payload) - 2 * k)
    (cs,) = struct.unpack_from("<H", payload)
    st = (F.native.decompress(payload[2: 2 + cs], k=2) if cs
          else payload[2: 2 + 2 * k])
    return (np.frombuffer(st, "<u2").astype(np.int32),
            len(payload) - 2 - (cs or 2 * k))


def _shares_of(items, n):
    return [items[lo:hi]
            for _, _, lo, hi in M.shares(len(items), (None,) * n)]


def _expected_compress(data, frame, ckw, n, repack, discarded) -> Counter:
    """The bytes each compress site allocates, from the frame and the
    knobs: the coded sections, RAW and RLE escapes, the frame's join, the
    shared-stream shares' gathered rows and symbol layout, the tail's
    gathered rows, the C++ merge's payloads (on its route), the copy of a
    ``bytes`` input. ``discarded``: the counts of coding the blocks that
    fell back to RAW, whose coded sections the frame does not hold."""
    pf = F._parse_frame(frame)
    k, bs, total = pf.k, pf.block_size, len(data)
    want = Counter(discarded)
    want["calls"] = 1
    want["frame"] = len(frame)
    if ckw.get("as_bytes"):
        want["input"] = total
    full = total // bs
    cpp = repack is not True
    for i in range(pf.n_blocks):
        mode, rl = int(pf.modes[i]), min(bs, total - i * bs)
        if mode in (F.MODE_FSE, F.MODE_FSE_PL):
            want["sections"] += int(pf.lens[i])
        elif mode == F.MODE_RAW:
            want["escapes"] += rl
        elif mode == F.MODE_RLE:
            want["escapes"] += 1
        k_i = min(k, rl)
        if mode == F.MODE_FSE:
            want["gather"] += rl
            _, R, _, _, _ = encode_layout(rl, k_i)
            want["fse_syms"] += R * k_i + k_i
        elif mode == F.MODE_FSE_PL:
            if i >= full:  # the tail's rows are gathered on the host
                want["gather"] += rl
            if cpp:  # the group's buffer (8 bytes of slack a block
                # bit-packed), then each block's bytes
                lanes = _lane_sizes(pf, _payload(pf, i), k_i)[1]
                want["merge"] += 2 * lanes + (8 if pf.packed else 0)
    return +want


def _expected_decompress(frame, dkw, n, repack) -> Counter:
    """The bytes each decompress site allocates, from the frame: the
    sections sliced from it, the payloads past their headers (and, on the
    C++ route, past the lane sizes), the returned ``bytes`` (decoded into
    in place over a block-aligned range; an unaligned range's staging
    buffer besides), the shared-stream shares' padded words and the C++
    split's words."""
    pf = F._parse_frame(frame)
    bs, total = pf.block_size, pf.total_len
    start = dkw.get("start", 0)
    length = dkw.get("length", total - start)
    lo, hi = start // bs, -(-(start + length) // bs)
    span = min(hi * bs, total) - lo * bs
    want = Counter(calls=1)
    if not (start == lo * bs and span == length):
        want["out_buffer"] = span
    if not dkw.get("out"):
        want["output"] = length
    groups, pl_groups = {}, {}
    for i in range(lo, hi):
        mode, rl = int(pf.modes[i]), min(bs, total - i * bs)
        want["sections"] += int(pf.lens[i])
        if mode not in (F.MODE_FSE, F.MODE_FSE_PL):
            continue
        sec = pf.section(i)
        table, log2, payload = ((None, None, sec) if pf.shared
                                else F._read_block_header(sec))
        if pf.shared:
            log2 = F._read_block_header(pf.shared_hdr)[1]
        else:
            want["payloads"] += len(payload)
        dst = pl_groups if mode == F.MODE_FSE_PL else groups
        dst.setdefault((rl, log2), []).append(payload)
    for items in groups.values():
        for share in _shares_of(items, n):
            wd = -(-max(len(p) for p in share) // 4) + 2
            want["fse_words"] += len(share) * wd * 4
    k = pf.k
    for items in pl_groups.values():
        for share in _shares_of(items, n):
            lanes = [_lane_sizes(pf, p, k) for p in share]
            # the lane streams sliced past the size table: for the C++
            # split, and on either route past a packed one
            if pf.packed or repack is not True:
                want["payloads"] += sum(n_bytes for _, n_bytes in lanes)
            if repack is not True:
                top = max(int(sz.max()) for sz, _ in lanes)
                w = -(-(top // 32 + 3) // 16) * 16
                want["split"] += len(share) * w * k * 4
    return +want


def _discarded(data, ckw, frame) -> Counter:
    """The counts of coding, alone, each full block the frame stores RAW."""
    pf = F._parse_frame(frame)
    bs = pf.block_size
    got = Counter()
    for i in np.flatnonzero(pf.modes[: len(data) // bs] == F.MODE_RAW):
        block = data[i * bs:(i + 1) * bs]
        counts = np.bincount(block, minlength=256)[None]
        tables, logs = F.normalize_batch(counts, bs, F.TABLE_LOG_DEFAULT)
        before = dict(profiling.counters)
        F._encode_group(block[None], tables, logs, K, False, [b""],
                        np.zeros(1, np.int32), np.array([0]),
                        (torch.device("cpu"),), lanes=ckw["lanes"])()
        got += _counted(before, "compress")
    return got


@pytest.mark.parametrize("case", sorted(CASES), indirect=True)
def test_host_bytes_counters_equal_what_their_sites_allocate(case):
    data, given, ckw, dkw, n, repack = case
    before = dict(profiling.counters)
    frame = F.compress(given, **ckw)
    got = _counted(before, "compress")
    ckw = dict(ckw, as_bytes=isinstance(given, bytes))
    assert got == _expected_compress(data, frame, ckw, n, repack,
                                     _discarded(data, ckw, frame))
    before = dict(profiling.counters)
    _decompress(frame, dkw, n, bytearray(len(data)))
    assert _counted(before, "decompress") == _expected_decompress(
        frame, dkw, n, repack)


# --- the marks of FLAG_CRC and FLAG_PACKED -----------------------------------

# each flag's range, by op, and the stage it nests in
FLAG_RANGES = {("compress", "crc"): "ect.compress.frame",
               ("compress", "size_table"): "ect.compress.assemble",
               ("decompress", "crc"): "ect.decompress.output",
               ("decompress", "size_table"): "ect.decompress.checks"}


def _flag_counted(before: dict, op: str) -> Counter:
    """The ``crc.<op>`` and ``size_table.<op>.*`` counters made since
    ``before``."""
    got = Counter()
    for key, v in profiling.counters.items():
        d = v - before.get(key, 0)
        if d and (key in (f"crc.{op}", f"crc.{op}.device")
                  or key.startswith(f"size_table.{op}.")):
            got[key] = d
    return got


def _expected_flag_counts(frame, dkw, op: str) -> Counter:
    """From the frame: the raw bytes of the blocks a call checksums (every
    block on compress, the range's blocks on decompress), those of them
    checksummed on the device (the full blocks, which were placed there, on
    compress; the per-lane blocks, decoded there, on decompress; never a
    RAW, RLE or MODE_FSE block's) and its per-lane blocks by the kind of
    their size table (k=2-coded or raw)."""
    pf = F._parse_frame(frame)
    bs = pf.block_size
    lo, hi = 0, pf.n_blocks
    if op == "decompress" and "start" in dkw:
        lo = dkw["start"] // bs
        hi = -(-(dkw["start"] + dkw["length"]) // bs)
    want = Counter()
    if pf.crcs is not None:
        want[f"crc.{op}"] = min(hi * bs, pf.total_len) - lo * bs
        if op == "compress":
            want["crc.compress.device"] = pf.total_len // bs * bs
        else:
            want["crc.decompress.device"] = sum(
                min(bs, pf.total_len - i * bs) for i in range(lo, hi)
                if int(pf.modes[i]) == F.MODE_FSE_PL)
    if pf.packed:
        for i in range(lo, hi):
            if int(pf.modes[i]) == F.MODE_FSE_PL:
                (cs,) = struct.unpack_from("<H", _payload(pf, i))
                want[f"size_table.{op}.{'coded' if cs else 'raw'}"] += 1
    return +want


def _parents(log, name: str) -> list:
    """The range that holds each entry of ``name`` in a ``Ranges`` log."""
    stack, out = [], []
    for what, n in log:
        if what == "enter":
            if n == name:
                out.append(stack[-1] if stack else None)
            stack.append(n)
        else:
            stack.pop()
    return out


def _flagged(name: str) -> bool:
    ckw = CASES[name][1]
    return bool(ckw.get("checksum") or ckw.get("bit_pack"))


def _call_both(case, ranges):
    """Compress and decompress case ``case`` once each; yield, per op, the
    frame, the flag counters the call made and the ranges it entered."""
    data, given, ckw, dkw, n, _ = case
    frame = None
    for op in ("compress", "decompress"):
        before = dict(profiling.counters)
        ranges.log.clear()
        if op == "compress":
            frame = F.compress(given, **ckw)
        else:
            _decompress(frame, dkw, n, bytearray(len(data)))
        yield op, frame, _flag_counted(before, op), list(ranges.log)


@pytest.mark.parametrize("case", sorted(CASES), indirect=True)
def test_flag_ranges_and_counters_hold_exactly(case, ranges):
    """``crc.<op>`` counts the raw bytes of the blocks checksummed,
    ``size_table.<op>.coded`` + ``.raw`` the per-lane blocks of a packed
    frame; each crc pass is one ``ect.<op>.crc`` range and each size table
    one ``ect.<op>.size_table`` range, nested in the stage that runs it."""
    dkw = case[3]
    for op, frame, got, log in _call_both(case, ranges):
        want = _expected_flag_counts(frame, dkw, op)
        assert got == want, op
        tables = sum(v for key, v in want.items()
                     if key.startswith("size_table."))
        for mark, n_ranges in (("crc", int(f"crc.{op}" in want)),
                               ("size_table", tables)):
            held_by = _parents(log, f"ect.{op}.{mark}")
            assert held_by == [FLAG_RANGES[op, mark]] * n_ranges, (op, mark)


@pytest.mark.parametrize("case", sorted(c for c in CASES if not _flagged(c)),
                         indirect=True)
def test_a_frame_without_the_flags_makes_none_of_their_marks(case, ranges):
    for op, frame, got, log in _call_both(case, ranges):
        assert not got, op
        assert not [n for _, n in log
                    if n.endswith((".crc", ".size_table"))], op


def test_a_caller_buffer_counts_no_output_bytes(monkeypatch):
    data = _data("lanes", BS)
    frame = F.compress(data, block_size=BS, k=K, device="cpu")
    before = dict(profiling.counters)
    out = np.empty(len(data), np.uint8)
    assert F.decompress(frame, out=out, device="cpu") == len(data)
    got = _counted(before, "decompress")
    assert got["calls"] == 1
    assert got["out_buffer"] == got["output"] == 0
    assert out.tobytes() == data.tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_uncounted_host_buffer_of_the_inputs_size(name, monkeypatch):
    """``tracemalloc``'s peak during one call stays within the counted
    bytes plus the call's input: a site that allocates a buffer as large
    as the input without counting it would pass that bound. The blocks
    are 64 KiB, so that the per-block scratch of the host codec (the
    normalization's, ~25 KB a block whatever its size; the tables of the
    C++ build) stays under a block's bytes, as at the sizes users run."""
    data, given, ckw, dkw, n, _ = _build(name, 1 << 16, monkeypatch)
    F.compress(given, **ckw)  # build the host library, load the modules
    out = bytearray(len(data))  # the caller's buffer, made before the call
    tracemalloc.start()
    try:
        for op in ("compress", "decompress"):
            before = dict(profiling.counters)
            base = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            if op == "compress":
                frame = F.compress(given, **ckw)
                size = len(data)
            else:
                _decompress(frame, dkw, n, out)
                size = len(frame)
            peak = tracemalloc.get_traced_memory()[1] - base
            counted = sum(v for key, v in _counted(before, op).items()
                          if key != "calls")
            assert peak <= counted + size, (op, peak, counted, size)
    finally:
        tracemalloc.stop()


# --- the calls' behaviour, pinned -------------------------------------------
#
# Every case of ``CASES`` at its own ranks and at 1 and 4, on both repack
# routes, and decompress variants of two frames (a block-aligned and an
# unaligned range, each with and without ``out=``; a corrupt frame, whole
# and over a range), on one rank and the C++ repack and on four ranks and
# the device repack: for each call the ``ect.*`` ranges it opens, in order
# and with their depth, the change in every counter, and the sha256 of what
# it returns (with ``out=``, of the buffer's range too) or the error it
# raises, equal those in ``PINS`` exactly. Regenerate the file with
# ``python -m tests.test_torch_call_tracing`` on the commit whose behaviour
# it should pin.

PINS = Path(__file__).parent / "data" / "call_pins.json"

# decompress variants: (start, length) in blocks and bytes past them, and
# whether the caller gives ``out=``; "corrupt*" flip a byte of block 2's
# section first, "crc_mismatch" one of its crc
VARIANTS = {"aligned": ((1, 0), (3, 0), False),
            "aligned_out": ((1, 0), (3, 0), True),
            "unaligned": ((1, 17), (3, 0), False),
            "unaligned_out": ((1, 17), (3, 0), True),
            "corrupt": (None, None, False),
            "corrupt_range": ((1, 17), (3, 0), False),
            "corrupt_range_out": ((1, 17), (3, 0), True),
            "crc_mismatch": (None, None, False)}


# ``CASES`` and two frames of two table-log groups, each group a round of
# shares and the crc kernels queued behind the last one's encode (not in
# ``CASES``: the lane path may gather such a group's shares on the host,
# which ``_expected_compress`` does not model)
PIN_CASES = dict(CASES, crc_two_groups=(
    "groups", dict(lanes=True, checksum=True), 2, {}, None), fse_two_groups=(
    "groups", dict(lanes=False, checksum=True, table_log=("fast", 0.0025)),
    2, {}, None))


def _pin_cases() -> dict:
    """Pin id -> (case of ``PIN_CASES``, ranks, repack switch, variant)."""
    pins = {}
    for name, (_, _, n0, _, _) in PIN_CASES.items():
        for n in sorted({n0, 1, 4}):
            for repack in (None, True):
                pins[f"{name}-{n}-{repack}"] = (name, n, repack, None)
    for name in ("crc_fse_tail_mesh3", "crc_fse_raw_fallback"):
        for variant in VARIANTS:
            for n, repack in ((1, None), (4, True)):
                pins[f"{name}-{variant}-{n}-{repack}"] = (name, n, repack,
                                                         variant)
    return pins


@functools.lru_cache(maxsize=1)
def _pins() -> dict:
    return json.loads(PINS.read_text())


class _DepthRanges:
    """Stands in for ``record_function``: logs "<depth> <name>" a range."""

    def __init__(self):
        self.log, self.depth = [], 0

    @contextlib.contextmanager
    def __call__(self, name):
        self.log.append(f"{self.depth} {name}")
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1


def _corrupt(frame: bytes, variant: str) -> bytes:
    """``frame`` with one byte of block 2's section, or of its crc,
    flipped."""
    pf = F._parse_frame(frame)
    if variant == "crc_mismatch":  # the crc table ends where block 0 starts
        at = int(pf.offs[0]) - 4 * (pf.n_blocks - 2)
    else:
        at = int(pf.offs[2]) + int(pf.lens[2]) // 2
    bad = bytearray(frame)
    bad[at] ^= 0x5A
    return bytes(bad)


def _pinned_call(fn, ranges) -> dict:
    """Run ``fn`` (which returns what the call returned and the bytes to
    hash) and record its ranges, counters and result."""
    ranges.log.clear()
    before = dict(profiling.counters)
    try:
        got, digest = fn()
        result = {"returned": got if isinstance(got, int) else None,
                  "sha256": hashlib.sha256(digest).hexdigest()}
    except ValueError as e:
        result = {"error": f"{type(e).__name__}: {e}"}
    counters = {key: v - before.get(key, 0)
                for key, v in profiling.counters.items()
                if v != before.get(key, 0)}
    return dict(result, ranges=list(ranges.log), counters=counters)


def _record_pin(pin, mp) -> dict:
    """What case ``pin`` of ``_pin_cases`` does, compress and decompress."""
    name, n, repack, variant = _pin_cases()[pin]
    kind, ckw, _, dkw, _ = PIN_CASES[name]
    mp.setattr(F, "_DEVICE_REPACK", repack)
    ranges = _DepthRanges()
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("entropy_coders_tpu_torch"):
            for attr, v in list(vars(mod).items()):
                if v is record_function:
                    mp.setattr(mod, attr, ranges)
    ckw = dict(ckw)
    data = _data(kind, BS)
    given = data.tobytes() if ckw.pop("as_bytes", False) else data
    frame = None

    def compress():
        nonlocal frame
        frame = F.compress(given, block_size=BS, k=K, **ckw, **_place(n))
        return frame, frame

    got = {"compress": _pinned_call(compress, ranges)}
    if variant is None:
        dkw = dict(dkw)
        with_out = dkw.pop("out", False)
        if "start" in dkw:
            dkw = dict(start=BS + dkw["start"], length=dkw["length"] * BS)
    else:
        at, size, with_out = VARIANTS[variant]
        if variant.startswith(("corrupt", "crc")):
            frame = _corrupt(frame, variant)
        dkw = {} if at is None else dict(start=at[0] * BS + at[1],
                                         length=size[0] * BS + size[1])
    length = dkw.get("length", len(data) - dkw.get("start", 0))

    def decompress():
        if not with_out:
            back = F.decompress(frame, **dkw, **_place(n))
            return back, back
        out = bytearray(length + 5)
        back = F.decompress(frame, out=out, **dkw, **_place(n))
        return back, bytes(out[:length])

    got["decompress"] = _pinned_call(decompress, ranges)
    return got


@pytest.mark.parametrize("pin", sorted(_pin_cases()))
def test_calls_reproduce_their_pinned_ranges_counters_and_bytes(pin):
    want = _pins()[pin]
    with pytest.MonkeyPatch.context() as mp:
        got = _record_pin(pin, mp)
    for op in ("compress", "decompress"):
        for what in ("ranges", "counters", "sha256", "returned", "error"):
            assert got[op].get(what) == want[op].get(what), (op, what)


if __name__ == "__main__":
    pins = {}
    with pytest.MonkeyPatch.context() as mp:
        for pin in sorted(_pin_cases()):
            pins[pin] = _record_pin(pin, mp)
            mp.undo()
    PINS.write_text(json.dumps(pins, indent=0, sort_keys=True) + "\n")

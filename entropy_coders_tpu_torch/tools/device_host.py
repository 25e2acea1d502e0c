"""D1-D3 and D6 on the card: the lane repack (``ops.device_repack``,
kernels ``ect_lane_merge``/``ect_lane_split``) and the table build
(``ops.tables``, ``ect_build_tables``) held against their plain PyTorch
versions and against the port's C++ host library, exactly, and timed at the
main path's launch shapes (``tools.lane_shapes.SHAPES``) beside their bounds
and the C++ calls; the per-block histogram (``ops.histogram``,
``ect_histogram``) against its plain version and timed at its launch shapes
(``HIST_SHAPES``) beside its bound and the ``bincount`` route.

    python -m entropy_coders_tpu_torch.tools.device_host [--old DIR]
        [--rounds N] [--histogram] [--crc]

prints one JSON line per check and per launch shape. ``chip_smoke.py``
drives the same functions in its phase ``device_host``. At each shape a
wrapper call of D1 and of D2 also runs once under ``torch.profiler``; the
device ops it issued are listed and must be at most two kernels and no
memset or fill. D3 is checked in each half (decode, encode, both) at L =
5..15 and at every cluster size ``ops.tables.launch_config`` can pick there
(``tables.cluster_choices``), and timed at ``TABLE_SHAPES``: the launch
shapes of one ~64 MiB chunk (B = 4 at L = 8 and 11, 512 at L = 10, and 4
at L = 15) and of one lane group (8 at L = 8 and 11, 1,022 at L = 10),
each half on its own: a wrapper call (CUDA events over queued calls), the
host's time for the wrapper to return, the kernel alone (the profiler's
device time of one call: one kernel, no memset or fill), and the floor of
such a launch, a kernel that does nothing launched the same way (same grid,
cluster, threads and shared memory, through the same wrapper). ``--old DIR``
names a checkout of another commit (e.g. ``git archive <commit> | tar -x -C
build/parent``): its ``entropy_coders_tpu_torch/csrc/repack.cu`` is built
into a library of its own, and its merge and split, with what their
wrapper did around them, are timed against the current wrappers in turns
(old, new, new, old; ``--rounds`` times), their outputs compared exactly.
Its launchers are either the first design's (bit offsets in, a zeroed
output; the wrapper took ``lane_offsets`` and the zero fill) or the current
ones. Its ``tables.cu``, ``pl_decode.cu`` and ``pl_decode_layout.cu`` go
into another (``load_parent``): D3 is timed against the parent's call in
turns the same way, and ``chip_smoke.py`` times B1 and the layouts against
it.

D6 (``--histogram`` runs it alone) is checked where histograms break
(``check_histogram``: a constant, a uniform, the bench and a bf16 pattern;
n in {1, 15, 17, 4,097}; storage offsets 1..15; B = 0 and n = 0 give zeros
without a launch) and timed at every ``HIST_SHAPES`` shape: a wrapper call
(CUDA events over 20 queued calls behind a spin), the kernel alone (the
profiler's device time of one call: one kernel, no memset or fill), the
plain version on the same tensor (the offset ``bincount`` route, which is
also its ``library_ms``) in turns, and the byte bound; then the kernel alone
on each pattern at the throughput shape.

The crc kernel (``--crc`` runs it alone) is checked against
``zlib.crc32`` and its plain version (``check_crc``: the parity cell's
shape, odd lengths, storage offsets 1..15, the two-piece form of a decoded
block; B = 0 and no bytes give zeros without a launch) and timed at every
``CRC_SHAPES`` shape: a wrapper call, its two kernels alone (profiler), the
plain version and ``zlib.crc32`` on the host in turns, and the byte bound.

A bound is the bytes the function must move over 3.35 TB/s (an H100 SXM's
published peak): each input read once, each output written once, counted
from this run's sizes. Merge: the payload read from the words and written
to the wire, plus 4 bytes of size a lane. Split: the payload read, 4 bytes
of size a lane and 8 of offset a block, every word row written. Tables: 1
KiB of counts read a block, and the half's arrays written: 4 bytes a slot
(decode), or 2 bytes a slot and 2 KiB of transforms (encode). Histogram:
the blocks read and 2 KiB of counts a block written.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from .. import native
from ..kernels import build as KB
from ..normalize import normalize_batch
from ..ops import device_repack as DR
from ..ops import pl_coder as PL
from ..ops import tables as TB
from ..ops import crc as K
from ..ops import histogram as H
from ..ops.histogram import histogram_blocks
from ..ops.unsigned import to_device, to_numpy
from . import lane_shapes as LS
from .bench_data import cuda_ms

HBM_BYTES_PER_S = 3.35e12
# (k, B, W, smallest size, largest size + 1) of the repack's exactness cases
# (5-bit lanes: one wire word spans up to seven lanes; 512 blocks: the
# default launch's count)
REPACK_CASES = [(128, 3, 9, 0, 289), (1024, 5, 40, 5, 1281),
                (8192, 2, 70, 1000, 2241), (16384, 2, 264, 3000, 8449),
                (16384, 1, 33, 1000, 1057), (128, 4, 2, 5, 6),
                (1024, 512, 4, 5, 120)]


def random_lanes(rng, B: int, W: int, k: int, lo: int, hi: int, guard=False):
    """(words (B, W, k) uint32, sizes (B, k) int32) with sizes in [lo, hi)
    and, in block 0, a zero-size lane, one-bit and one-byte lanes, lanes
    that end on a word boundary (and, for W > 33, on a 32-row tile
    boundary) and a lane that fills all W rows. The bits
    past a lane's size are zero, as B2 leaves them, or, with ``guard``, set
    at random up to the end of the lane's last word (guard bits)."""
    sizes = rng.integers(lo, hi, (B, k)).astype(np.int32)
    sizes[0, :7] = [0, 1, 8, 32, 64, 32 * (W - 1), 32 * W]
    if W > 33:  # ends on a tile boundary (32 rows) and one word past it
        sizes[0, 7:9] = [1024, 1056]
    words = rng.integers(0, 1 << 32, (B, W, k), dtype=np.uint64).astype(
        np.uint32)
    rem = sizes[:, None, :] - 32 * np.arange(W)[None, :, None]
    if guard:
        words &= np.where(rem > 0, 0xFFFFFFFF, 0).astype(np.uint32)
    else:
        words &= np.where(rem >= 32, 0xFFFFFFFF,
                          (1 << np.clip(rem, 0, 31)) - 1).astype(np.uint32)
    return words, sizes


def require(cond, what: str) -> None:
    """Raise when a check of this tool fails (kept under ``python -O``)."""
    if not cond:
        raise AssertionError(what)


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest difference between the bytes of two contiguous tensors
    of one size on one device (0: the same bytes)."""
    a, b = (t.view(torch.uint8).reshape(-1) for t in (a, b))
    require(a.shape == b.shape, f"{a.numel()} bytes != {b.numel()} bytes")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max())


def _diff_host(got: torch.Tensor, want: np.ndarray) -> int:
    """The largest difference by value between a tensor and a host array
    of one shape."""
    got = to_numpy(got).astype(np.int64)
    require(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    return int(np.abs(got - want.astype(np.int64)).max()) if got.size else 0


def _diff_payloads(got: list, want: list) -> int:
    """The largest byte difference between two lists of payloads of equal
    lengths."""
    require([len(p) for p in got] == [len(p) for p in want],
            "payload lengths differ")
    a, b = (np.frombuffer(b"".join(p), np.uint8).astype(np.int16)
            for p in (got, want))
    return int(np.abs(a - b).max()) if a.size else 0


class Held:
    """Differences measured so far, each required to be 0: ``held(diff,
    what)`` raises AssertionError on a difference and keeps the largest in
    ``worst``."""

    def __init__(self):
        self.worst = 0

    def __call__(self, diff: int, what: str) -> None:
        self.worst = max(self.worst, diff)
        require(diff == 0, f"{what}: max abs difference {diff}")


def _payloads(flat: torch.Tensor, offs: torch.Tensor) -> list:
    flat, offs = flat.cpu().numpy(), offs.cpu().numpy()
    return [flat[offs[b]: offs[b + 1]].tobytes() for b in range(len(offs) - 1)]


def _framed(payloads, device, pre: int = 5):
    """The payloads end to end inside a larger buffer, from an odd byte on:
    (uint8 tensor on ``device``, (B,) int64 block offsets)."""
    buf = b"\xff" * pre + b"".join(payloads) + b"\xff" * 7
    offs = pre + np.concatenate([[0], np.cumsum([len(p) for p in payloads])[:-1]])
    return (DR.bytes_on(buf, 0, len(buf), device),
            torch.from_numpy(offs.astype(np.int64)).to(device))


def check_repack(device="cuda", seed: int = 0xD1) -> dict:
    """D1 and D2 against their plain versions on the same tensors and
    against ``native.lane_merge_batch``/``lane_split_batch``, exactly: both
    wire forms, k in {128, 1024, 8192, 16384}, clean words and words with
    guard bits. Raises AssertionError on any difference; ``max_abs_err`` is
    the largest difference measured over all compared outputs."""
    rng = np.random.default_rng(seed)
    n, held = 0, Held()
    for pack in (False, True):
        for k, B, W, lo, hi in REPACK_CASES:
            for guard in (False, True):
                tag = f"pack={pack} k={k} B={B} W={W} guard={guard}"
                words_np, sizes_np = random_lanes(rng, B, W, k, lo, hi, guard)
                words = to_device(words_np, device)
                sizes = torch.from_numpy(sizes_np).to(device)
                flat, offs = DR.lane_merge_device(words, sizes, pack_bits=pack)
                bit_off, _ = DR.lane_offsets(sizes, pack)
                want = DR.lane_merge_ref(words, sizes, bit_off,
                                         flat.numel() // 4, pack_bits=pack)
                end = -(-int(offs[-1]) // 4) * 4  # the payload's words
                held(_diff(flat[:end], want.view(torch.uint8)[:end]),
                     f"merge != plain version ({tag})")
                ref = native.lane_merge_batch(words_np, sizes_np, pack)
                held(_diff_payloads(_payloads(flat, offs), ref),
                     f"merge != C++ ({tag})")
                buf, boffs = _framed(ref, device)
                got = DR.lane_split_device(buf, boffs, sizes, k=k, W=W + 3,
                                           pack_bits=pack)
                bit_off, _ = DR.lane_offsets(sizes, pack, boffs)
                want = DR.lane_split_ref(
                    buf.view(torch.int32).view(torch.uint32), sizes, bit_off,
                    W=W + 3, pack_bits=pack)
                held(_diff(got, want), f"split != plain version ({tag})")
                held(_diff_host(got, native.lane_split_batch(
                    ref, sizes_np, k, W + 3, pack)), f"split != C++ ({tag})")
                n += 1
    return {"cases": n, "max_abs_err": held.worst}


def table_counts(rng, B: int, L: int) -> np.ndarray:
    """(B, 256) normalized counts at table log L from geometric data of
    differing skew: low-probability (-1) symbols, an alphabet that ends
    below 255 (transforms past table_len stay 0), counts above 256 from
    L = 10."""
    top = min(255, (1 << (L - 1)) - 2)
    rows = []
    for i in range(B):
        data = (rng.geometric(0.03 + 0.9 * (i % 7) / 7, 1 << 14) - 1).clip(
            0, top if i % 2 else top // 2)
        nt, l2 = native.normalize(np.bincount(data, minlength=256),
                                  len(data), L)
        require(l2 == L, f"table log raised to {l2} (L={L})")
        rows.append(nt)
    return np.stack(rows).astype(np.int32)


def _half_arrays(tables, half: str) -> list:
    """(name, array) of the fields ``half`` builds, LaneTables order."""
    return [(n, t) for n, t in zip(TB.HALF_FIELDS["both"], tables)
            if n in TB.HALF_FIELDS[half]]


def _cpp_tables(nt: np.ndarray, L: int):
    table, tt_bits, tt_fs = native.build_encode_tables(nt, L)
    return native.build_decode_tables(nt, L), tt_bits, tt_fs, table


def check_tables(device="cuda", seed: int = 0xD3) -> dict:
    """D3 against its plain version and against
    ``native.build_{encode,decode}_tables``, exactly, in each half: L =
    5..15 at B = 4 at every cluster size ``launch_config`` can pick at that
    L, B = 512 at L = 10 and B equal rows (the shared-table case) at the
    wrapper's pick; a half leaves the other half's fields None. Raises
    AssertionError on any difference; ``max_abs_err`` is the largest
    difference measured over all compared tables."""
    rng = np.random.default_rng(seed)
    cases = [(L, 4, False, C) for L in range(5, 16)
             for C in TB.cluster_choices(L)]
    cases += [(10, 512, False, None), (11, 8, True, None)]
    low, held, n = 0, Held(), 0
    for L, B, shared, C in cases:
        nt = table_counts(rng, 1 if shared else B, L)
        nt = np.repeat(nt, B, 0) if shared else nt
        low += int((nt == -1).sum())
        norm = torch.from_numpy(nt).to(device)
        cpp = _cpp_tables(nt, L)
        for half in TB.HALVES:
            got = TB.build_tables(norm, L, half, C)
            want = TB.build_tables_ref(norm, L, half)
            require(sum(t is not None for t in got)
                    == len(_half_arrays(got, half)),
                    f"{half}: another half's field built (L={L})")
            tag = f"L={L}, B={B}, half={half}, cluster={C}"
            for (name, g), (_, w), (_, c) in zip(_half_arrays(got, half),
                                                 _half_arrays(want, half),
                                                 _half_arrays(cpp, half)):
                held(_diff(g, w), f"{name} != plain version ({tag})")
                held(_diff_host(g, c), f"{name} != C++ ({tag})")
            n += 1
    require(low > 0, "no table with a -1 count")
    return {"cases": n, "clusters": sorted({c for *_, c in cases
                                            if c is not None}),
            "low_symbols": low, "max_abs_err": held.worst}


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _in_turns(kernel, cpp) -> dict:
    """Kernel (CUDA events, the median of 5 runs of 3 queued launches) and
    the C++ call (host clock, once) in turns: kernel, C++, C++, kernel."""
    k1 = cuda_ms(kernel, runs=5, reps=3)[0]
    c1 = _host_ms(cpp)
    c2 = _host_ms(cpp)
    k2 = cuda_ms(kernel, runs=5, reps=3)[0]
    return {"ms": min(k1, k2), "ms_turns": [k1, k2],
            "cpp_ms": min(c1, c2), "cpp_ms_turns": [c1, c2]}


def _bound(nbytes: int) -> dict:
    return {"bytes": int(nbytes), "bound_by": "bytes",
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def device_ops(fn, calls: int = 10, tries: int = 3) -> dict:
    """The device ops a call of ``fn`` issues, read from a
    ``torch.profiler`` window around ``calls`` calls (after one outside
    it): {name cut to 80 characters: {"calls": launches a call, "seen":
    the window's events a call, "us": device microseconds a call}}.

    A window can miss events (on an H100, inside ``chip_smoke.py`` after
    its traced phase, windows saw 17-18 of 20 kernels, and once none): so
    an op's row is ``op_row``'s, and a window that saw no kernel is taken
    again, up to ``tries`` windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = {e.key[:80]: op_row(e.count, e.self_device_time_total, calls)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count}
        if any(not _is_copy(k) for k in ops):
            break
    return ops


def op_row(count: int, device_us: float, calls: int) -> dict:
    """An op seen ``count`` times in a window of ``calls`` calls, for
    ``device_us`` in all: its launches a call (the events a call rounded,
    at least one), the events a call seen, and its device microseconds a
    call (the mean over the events seen, times the launches a call), so
    that events the window missed bias neither."""
    n = max(1, round(count / calls))
    return {"calls": n, "seen": count / calls, "us": device_us / count * n}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def kernel_ms(ops: dict, part: str = "") -> float:
    """Device ms a call of the kernels in ``ops`` (``device_ops``) whose
    name holds ``part``."""
    return sum(o["us"] for k, o in ops.items()
               if not _is_copy(k) and part in k) / 1e3


def check_ops(ops: dict, what: str) -> dict:
    """``ops`` (``device_ops``) hold at most two kernels a call, at least
    one, and no memset or fill; returns the kernels a call and ``ops``."""
    kernels = sum(o["calls"] for k, o in ops.items() if not _is_copy(k))
    require(0 < kernels <= 2, f"{what}: {kernels} kernels a call: {ops}")
    require(not any(k.startswith("Memset") or "fill" in k.lower()
                    for k in ops), f"{what}: a fill a call: {ops}")
    return {"kernels": kernels, "ops": ops}


def takes_bit_offsets(src: str) -> bool:
    """Whether a ``repack.cu`` has the first design's launchers (the lane
    offsets in, ``bit_off``) rather than the current ones."""
    head = src[src.index('extern "C" int ect_lane_merge('):]
    return "bit_off" in head[: head.index(")")]


def load_old(old_root: Path) -> ctypes.CDLL:
    """Build ``old_root``'s ``repack.cu`` into a library of its own (nvcc,
    the current flags) and load it; its ``first_design`` says which
    launchers it has (``takes_bit_offsets``)."""
    src = old_root / "entropy_coders_tpu_torch" / "csrc" / "repack.cu"
    text = src.read_text()
    h = hashlib.sha256(text.encode()).hexdigest()[:16]
    out = KB.build_dir() / f"libect_torch_old_repack_{h}.so"
    if not out.exists():
        KB.writable_build_dir()
        flags = [f for f in KB.COMPILE_FLAGS if f != "-c"]
        r = subprocess.run([KB._nvcc(), *flags, "-shared", "-o", str(out),
                            str(src)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old repack:\n{r.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.first_design = takes_bit_offsets(text)
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if lib.first_design:
        lib.ect_lane_merge.argtypes = [P, P, P, P, LL, I, I, I, I, P]
        lib.ect_lane_split.argtypes = [P, LL, P, P, P, I, I, I, I, P]
    else:
        for name in ("ect_lane_merge", "ect_lane_split"):
            getattr(lib, name).argtypes = KB._SIGNATURES[name]
    for fn in (lib.ect_lane_merge, lib.ect_lane_split):
        fn.restype = ctypes.c_int
    return lib


def _old_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"old {what} launch failed: CUDA error {rc}")


def old_merge(lib, words, sizes, pack_bits: bool):
    """The other commit's D1 call: the first design's wrapper's offsets
    (``lane_offsets``) and zero-filled bound buffer, then its kernel; or
    the current launcher into ``torch.empty`` outputs."""
    B, W, k = words.shape
    stream = torch.cuda.current_stream().cuda_stream
    if not lib.first_design:
        out = torch.empty(B * W * k, dtype=torch.int32, device=words.device)
        meta = torch.empty(2 * B + 1 + B * (k // 32), dtype=torch.int64,
                           device=words.device)
        _old_rc(lib.ect_lane_merge(
            words.data_ptr(), sizes.data_ptr(), out.data_ptr(), out.numel(),
            meta.data_ptr(), B, W, k, int(pack_bits), stream), "merge")
        return out.view(torch.uint8), meta[: B + 1]
    bit_off, offs = DR.lane_offsets(sizes, pack_bits)
    out = torch.zeros(B * W * k, dtype=torch.int32, device=words.device)
    _old_rc(lib.ect_lane_merge(
        words.data_ptr(), sizes.data_ptr(), bit_off.data_ptr(),
        out.data_ptr(), out.numel(), B, W, k, int(pack_bits), stream),
        "merge")
    return out.view(torch.uint8), offs


def old_split(lib, flat, block_offs, sizes, *, k: int, W: int,
              pack_bits: bool):
    """The other commit's D2 call: the first design's wrapper's offsets,
    then its kernel; or the current launcher (``flat`` a multiple of 4
    bytes, 16-byte aligned)."""
    B = sizes.shape[0]
    packed = flat.view(torch.int32)
    words = torch.empty((B, W, k), dtype=torch.int32, device=flat.device)
    stream = torch.cuda.current_stream().cuda_stream
    if not lib.first_design:
        goff = torch.empty(B * (k // 32), dtype=torch.int64,
                           device=flat.device)
        _old_rc(lib.ect_lane_split(
            packed.data_ptr(), packed.numel(), sizes.data_ptr(),
            block_offs.data_ptr(), goff.data_ptr(), words.data_ptr(), B, W,
            k, int(pack_bits), stream), "split")
        return words.view(torch.uint32)
    bit_off, _ = DR.lane_offsets(sizes, pack_bits, block_offs)
    _old_rc(lib.ect_lane_split(
        packed.data_ptr(), packed.numel(), sizes.data_ptr(),
        bit_off.data_ptr(), words.data_ptr(), B, W, k, int(pack_bits),
        stream), "split")
    return words.view(torch.uint32)


def old_in_turns(old_call, new_call, rounds: int) -> dict:
    """The other commit's call and the current one in turns (old, new, new,
    old) x ``rounds``, each turn the median of 5 runs of 3 queued calls."""
    times = {"old": [], "new": []}
    for who in ["old", "new", "new", "old"] * rounds:
        fn = old_call if who == "old" else new_call
        times[who].append(cuda_ms(fn, runs=5, reps=3)[0])
    return {"old_ms": statistics.median(times["old"]),
            "new_ms_in_turns": statistics.median(times["new"]),
            "old_ms_turns": times["old"], "new_ms_turns": times["new"]}


def shape_repack(inp: LS.ShapeInputs, pack_bits: bool, old=None,
                 rounds: int = 2) -> dict:
    """D1 and D2 at one launch shape, on B2's real output: split of merge
    is the identity (both wire forms), the merge equals the C++ merge, both
    equal their plain versions (each row's ``max_abs_err`` is the largest
    difference measured), the device ops of one wrapper call
    (``check_ops``), and the wrappers' times (CUDA events over queued
    calls) beside the kernels' device time (``kernel_ms``, the profiler's,
    both kernels), the launchers' alone (outputs allocated once), the plain
    versions', the C++ calls' and the bounds, in the wire form
    ``pack_bits``. With ``old``
    (``load_old``), the other commit's calls too, in turns with the
    current ones, outputs equal."""
    B, k, W = inp.B, inp.k, inp.W
    words, sizes = inp.words, inp.sizes
    sizes_np = sizes.cpu().numpy()
    max_bits = int(sizes_np.max())
    w_dec = -(-(max_bits // 32 + 3) // 16) * 16   # the container's decode W
    w_act = min(-(-(max_bits // 32 + 2) // 16) * 16, W)
    words_np = to_numpy(words[:, :w_act].contiguous())
    merge_held, split_held = Held(), Held()
    for pack in (False, True):
        flat, offs = DR.lane_merge_device(words, sizes, pack_bits=pack)
        back = DR.lane_split_device(flat, offs[:-1], sizes, k=k, W=w_dec,
                                    pack_bits=pack)
        rows = min(w_dec, W)
        split_held(_diff(back[:, :rows].contiguous(),
                         words[:, :rows].contiguous()),
                   f"{inp.name}: split of merge != the words (pack={pack})")
        past = back[:, rows:].contiguous()
        split_held(_diff(past, torch.zeros_like(past)),
                   f"{inp.name}: rows past the words not zero (pack={pack})")
        if pack == pack_bits:
            payloads = _payloads(flat, offs)
            merge_held(_diff_payloads(payloads, native.lane_merge_batch(
                words_np, sizes_np, pack)), f"{inp.name}: merge != C++ merge")
            n = -(-int(offs[-1]) // 4) * 4  # the payload's words
            merge_held(_diff(flat[:n], DR.lane_merge_ref(
                words, sizes, DR.lane_offsets(sizes, pack)[0],
                flat.numel() // 4, pack_bits=pack).view(torch.uint8)[:n]),
                f"{inp.name}: merge != plain version")
            split_held(_diff(back, DR.lane_split_ref(
                flat.view(torch.int32).view(torch.uint32), sizes,
                DR.lane_offsets(sizes, pack, offs[:-1])[0], W=w_dec,
                pack_bits=pack)), f"{inp.name}: split != plain version")
            keep = flat, offs
    flat, offs = keep
    total = int(offs[-1])
    boffs = offs[:-1].contiguous()
    dev = flat.device
    lib = KB.load()
    stream = torch.cuda.current_stream().cuda_stream

    def merge_call():
        return DR.lane_merge_device(words, sizes, pack_bits=pack_bits)

    def split_call():
        return DR.lane_split_device(flat, boffs, sizes, k=k, W=w_dec,
                                    pack_bits=pack_bits)

    out = torch.empty(flat.numel() // 4, dtype=torch.int32, device=dev)
    meta = torch.empty(2 * B + 1 + B * (k // 32), dtype=torch.int64,
                       device=dev)
    merge = _in_turns(merge_call, lambda: native.lane_merge_batch(
        words_np, sizes_np, pack_bits))
    merge["launcher_ms"] = cuda_ms(lambda: lib.ect_lane_merge(
        words.data_ptr(), sizes.data_ptr(), out.data_ptr(), out.numel(),
        meta.data_ptr(), B, W, k, int(pack_bits), stream), reps=LS.REPS)[0]
    bit_off, _ = DR.lane_offsets(sizes, pack_bits)
    merge["plain_ms"] = cuda_ms(lambda: DR.lane_merge_ref(
        words, sizes, bit_off, out.numel(), pack_bits=pack_bits), runs=2,
        warmup=0)[0]
    ops = device_ops(merge_call)
    merge["device_ops"] = check_ops(ops, f"{inp.name} merge")
    merge["kernel_ms"] = kernel_ms(ops)
    merge.update(_bound(2 * total + 4 * B * k), max_abs_err=merge_held.worst)

    packed = flat.view(torch.int32).view(torch.uint32)
    split_off, _ = DR.lane_offsets(sizes, pack_bits, boffs)
    dst = torch.empty((B, w_dec, k), dtype=torch.int32, device=dev)
    goff = torch.empty(B * (k // 32), dtype=torch.int64, device=dev)
    split = _in_turns(split_call, lambda: native.lane_split_batch(
        payloads, sizes_np, k, w_dec, pack_bits))
    split["launcher_ms"] = cuda_ms(lambda: lib.ect_lane_split(
        packed.data_ptr(), packed.numel(), sizes.data_ptr(),
        boffs.data_ptr(), goff.data_ptr(), dst.data_ptr(), B, w_dec, k,
        int(pack_bits), stream), reps=LS.REPS)[0]
    split["plain_ms"] = cuda_ms(lambda: DR.lane_split_ref(
        packed, sizes, split_off, W=w_dec, pack_bits=pack_bits), runs=2,
        warmup=0)[0]
    ops = device_ops(split_call)
    split["device_ops"] = check_ops(ops, f"{inp.name} split")
    split["kernel_ms"] = kernel_ms(ops)
    split.update(_bound(total + 4 * B * k + 8 * B + 4 * B * w_dec * k),
                 max_abs_err=split_held.worst)

    if old is not None:
        o_flat, o_offs = old_merge(old, words, sizes, pack_bits)
        require(torch.equal(o_offs, offs)
                and torch.equal(o_flat[:total], flat[:total]),
                f"{inp.name}: old and new merge differ")
        require(torch.equal(old_split(old, flat, boffs, sizes, k=k, W=w_dec,
                                      pack_bits=pack_bits).view(torch.int32),
                            split_call().view(torch.int32)),
                f"{inp.name}: old and new split differ")
        merge.update(old_in_turns(
            lambda: old_merge(old, words, sizes, pack_bits), merge_call,
            rounds))
        split.update(old_in_turns(
            lambda: old_split(old, flat, boffs, sizes, k=k, W=w_dec,
                              pack_bits=pack_bits), split_call, rounds))
        # the device time of the other commit's calls: its repack kernel,
        # and every op its wrapper issued
        for row, call, name in (
                (merge, lambda: old_merge(old, words, sizes, pack_bits),
                 "lane_merge_kernel"),
                (split, lambda: old_split(old, flat, boffs, sizes, k=k,
                                          W=w_dec, pack_bits=pack_bits),
                 "lane_split_kernel")):
            ops = device_ops(call)
            row["old_kernel_ms"] = kernel_ms(ops, name)
            row["old_device_ms"] = kernel_ms(ops)
            row["old_device_ops"] = sum(o["calls"] for o in ops.values())
    return {"B": B, "k": k, "L": inp.L, "W": W, "W_decode": w_dec,
            "pack_bits": pack_bits, "payload_bytes": total, "merge": merge,
            "split": split}


# name -> (B, block bytes, table log; None: the default policy's): one
# chunk's launch (and L = 15) and one lane group's (the
# container builds a group's tables once: 8 blocks of 16 MiB at the
# throughput and parity points, the default point's ~1,022 of 128 KiB)
TABLE_SHAPES = {"throughput": (4, 16 << 20, 8), "parity": (4, 16 << 20, 11),
                "default": (512, 128 << 10, None),
                "throughput_L15": (4, 16 << 20, 15),
                "group_throughput": (8, 16 << 20, 8),
                "group_parity": (8, 16 << 20, 11),
                "group_default": (1022, 128 << 10, None)}


def _cpp_half(nt: np.ndarray, L: int, half: str):
    if half != "decode":
        native.build_encode_tables(nt, L)
    if half != "encode":
        native.build_decode_tables(nt, L)


def host_ms(fn, calls: int = 20) -> float:
    """The host's ms for ``fn`` to return, the mean over ``calls`` calls
    after one outside them, the card synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def tables_row(name: str, blocks: torch.Tensor, L: int, parent=None,
               rounds: int = 2) -> dict:
    """D3 on the normalized counts of ``blocks`` (B, block bytes) on the
    card at table log ``L``: each half equal to the C++ build and to its
    plain version (``max_abs_err``: the largest difference measured). Each
    half: a wrapper call (CUDA events over queued calls) in turns with the
    C++ build of that half, the host's time for a call to return, the
    plain version's, the kernel alone (``kernel_ms``, the profiler's
    device time of one call: one kernel, no memset or fill), the floor of
    such a launch (``empty_ms`` through the wrapper, ``empty_kernel_ms``
    alone) and the byte bound. With ``parent`` (``load_parent``), its call
    (which built both halves) in turns with a current call of both."""
    B, n = blocks.shape
    nt, logs = normalize_batch(histogram_blocks(blocks).cpu().numpy(), n, L)
    require((logs == L).all(), f"{name}: table log raised above {L}")
    nt = TB.check_norm_tables(nt, L)
    norm = to_device(nt, blocks.device)
    cpp = _cpp_tables(nt, L)
    held = Held()
    for half in TB.HALVES:
        for (_, g), (_, p), (_, w) in zip(
                _half_arrays(TB.build_tables(norm, L, half), half),
                _half_arrays(TB.build_tables_ref(norm, L, half), half),
                _half_arrays(cpp, half)):
            held(_diff_host(g, w), f"{name}: D3 != the C++ tables ({half})")
            held(_diff(g, p), f"{name}: D3 != plain version ({half})")
    C, T = TB.launch_config(B, L, torch.cuda.get_device_properties(
        blocks.device).multi_processor_count)
    row = {"B": B, "L": L, "cluster": C, "threads": T,
           "max_abs_err": held.worst}
    for half in ("decode", "encode"):
        def call(h=half):
            TB.build_tables(norm, L, h)

        def empty(h=half):
            TB.build_tables(norm, L, h, empty=True)

        r = _in_turns(call, lambda h=half: _cpp_half(nt, L, h))
        r["host_ms"] = host_ms(call)
        r["plain_ms"] = cuda_ms(lambda h=half: TB.build_tables_ref(norm, L, h),
                                runs=2, warmup=1)[0]
        ops = device_ops(call)
        r["device_ops"] = check_ops(ops, f"{name} tables {half}")
        require(r["device_ops"]["kernels"] == 1,
                f"{name}: D3 issued {r['device_ops']['kernels']} kernels a "
                "call")
        r["kernel_ms"] = kernel_ms(ops)
        r["empty_ms"] = cuda_ms(empty, runs=5, reps=3)[0]
        r["empty_kernel_ms"] = kernel_ms(device_ops(empty))
        slot_bytes = 4 if half == "decode" else 2
        r.update(_bound(B * (1024 + slot_bytes * (1 << L)
                             + (2048 if half == "encode" else 0))))
        r["share_of_bound"] = r["bound_ms"] / r["kernel_ms"]
        r["share_of_empty"] = r["empty_kernel_ms"] / r["kernel_ms"]
        row[half] = r
    if parent is not None:
        got = old_tables(parent, norm, L)
        for (_, g), (_, w) in zip(_half_arrays(got, "both"),
                                  _half_arrays(cpp, "both")):
            require(_diff_host(g, w) == 0, f"{name}: the parent's D3 differs")
        row["both"] = old_in_turns(lambda: old_tables(parent, norm, L),
                                   lambda: TB.build_tables(norm, L, "both"),
                                   rounds)
        ops = device_ops(lambda: old_tables(parent, norm, L))
        row["both"]["old_kernel_ms"] = kernel_ms(ops)
    return row


def tables_shapes(data: np.ndarray, parent=None, device="cuda") -> dict:
    """``tables_row`` at every ``TABLE_SHAPES`` shape, on the first B
    blocks of ``data`` (cycled where it is shorter)."""
    out = {}
    for name, (B, block, L) in TABLE_SHAPES.items():
        L = L if L is not None else LS.default_log(data, block)
        blocks = np.resize(data, B * block).reshape(B, block)
        out[name] = tables_row(name, torch.from_numpy(blocks).to(device), L,
                               parent)
    return out


def tables_sweep(data: np.ndarray, device="cuda") -> dict:
    """D3's decode half alone (the profiler's device time of one call) at
    every ``TABLE_SHAPES`` shape, every cluster size ``launch_config`` can
    pick at its L that keeps the CTAs within the SMs, and every CTA size:
    {shape: {"C<c>_T<t>": ms}} beside the wrapper's pick."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    for name, (B, block, L) in TABLE_SHAPES.items():
        L = L if L is not None else LS.default_log(data, block)
        blocks = np.resize(data, B * block).reshape(B, block)
        nt, _ = normalize_batch(histogram_blocks(
            torch.from_numpy(blocks).to(device)).cpu().numpy(), block, L)
        norm = to_device(TB.check_norm_tables(nt, L), device)
        row = {"B": B, "L": L, "pick": TB.launch_config(B, L, n_sm)}
        for C in TB.cluster_choices(L):
            if C > 1 and B * C > n_sm:
                continue
            for T in (128, 256, 512):
                row[f"C{C}_T{T}"] = kernel_ms(device_ops(
                    lambda: TB.build_tables(norm, L, "decode", C, threads=T)))
        out[name] = row
    return out


# --- D6, the per-block histogram -------------------------------------------------

# D6's launch shapes on the main path, (B, block bytes): a share of the
# throughput and parity points (their 8 blocks of 16 MiB, one share
# unsharded), the default and shared-stream points' 1,024 blocks of 128
# KiB, one share of 8 virtual ranks at each, config 4's 1 GiB of 4 MiB blocks
# on one card, and graft's one 4,096-byte block
HIST_SHAPES = {"throughput": (8, 16 << 20), "default": (1024, 128 << 10),
               "share_8_ranks": (1, 16 << 20),
               "share_8_ranks_default": (128, 128 << 10),
               "config4": (256, 4 << 20), "graft": (1, 4096)}
# the byte patterns timed side by side at the throughput shape: one value a
# block (every lane of a warp on one bin), uniform bytes, the bench data
# (byte 0 ~20%), the bytes of bf16 normals (the exponents on a few bins)
HIST_PATTERNS = ("constant", "uniform", "bench", "bf16")
HOLD_CYCLES = 20_000_000  # the spin each timed run waits behind (~10 ms)


def _diff_counts(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest difference by value between two count tensors."""
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a - b).abs().max()) if a.numel() else 0


def hist_pattern(kind: str, B: int, n: int, device="cuda",
                 seed: int = 0xD6) -> torch.Tensor:
    """(B, n) uint8 rows of one of ``HIST_PATTERNS`` on ``device``, made
    from ``seed`` (the bench data: ``gen_sequence(0.2)`` cycled)."""
    from .bench_data import gen_sequence

    if kind == "bench":
        return torch.from_numpy(np.resize(gen_sequence(0.2, min(
            B * n, 128 << 20)), B * n).reshape(B, n)).to(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    if kind == "constant":
        vals = torch.randint(0, 256, (B, 1), generator=g, dtype=torch.uint8)
        return vals.to(device).expand(B, n).contiguous()
    if kind == "uniform":
        return torch.randint(0, 256, (B, n), generator=g,
                             dtype=torch.uint8).to(device)
    if kind == "bf16":
        x = torch.randn(B * n // 2 + 1, generator=g).to(torch.bfloat16)
        return x.view(torch.uint8)[: B * n].reshape(B, n).to(device)
    raise ValueError(f"unknown pattern {kind}")


def check_histogram(device="cuda") -> dict:
    """D6 against its plain version on the same tensors of ``device``,
    exactly, where histograms break: each ``HIST_PATTERNS`` pattern at
    (4, 1 MiB); n in {1, 15, 17, 4,097} at B in {1, 3, 9}; the first row of
    a view at every storage offset 1..15; B = 0 and n = 0 (zeros, no
    launch). Each other case launches D6 exactly once."""
    cases = [(f"{kind}_4x1MiB", hist_pattern(kind, 4, 1 << 20, device))
             for kind in HIST_PATTERNS]
    cases += [(f"uniform_{B}x{n}", hist_pattern("uniform", B, n, device,
                                                seed=B * n))
              for n in (1, 15, 17, 4097) for B in (1, 3, 9)]
    flat = hist_pattern("uniform", 1, 3 * 4097 + 16, device)[0]
    cases += [(f"offset_{off}", flat[off: off + 3 * 4097].view(3, 4097))
              for off in range(1, 16)]
    held = Held()
    for name, t in cases:
        before = H.HIST_LAUNCHES
        got = H.histogram_call(t)
        require(H.HIST_LAUNCHES == before + 1,
                f"{name}: {H.HIST_LAUNCHES - before} D6 launches")
        held(_diff_counts(got, H.histogram_blocks_ref(t)),
             f"{name}: D6 != plain version")
        require(int(got.sum()) == t.numel(), f"{name}: counts lost")
    for shape in ((0, 16), (3, 0)):
        before = H.HIST_LAUNCHES
        got = H.histogram_call(torch.empty(shape, dtype=torch.uint8,
                                           device=device))
        require(H.HIST_LAUNCHES == before and got.shape == (shape[0], 256)
                and not bool(got.any()), f"{shape}: not zeros without a "
                "launch")
    return {"cases": len(cases) + 2, "max_abs_err": held.worst}


def histogram_row(name: str, blocks: torch.Tensor, rounds: int = 2) -> dict:
    """D6 at one launch shape: equal to its plain version on the same
    tensor; a wrapper call (CUDA events over queued calls behind a spin),
    the kernel alone (the profiler's device time of one call: one kernel,
    no memset or fill), the plain version (the offset ``bincount`` route,
    the one PyTorch call that computes the same function: ``library_ms``),
    in turns, and the byte bound: the blocks read once, the counts written
    once."""
    B, n = blocks.shape
    got = H.histogram_call(blocks)
    err = _diff_counts(got, H.histogram_blocks_ref(blocks))
    require(err == 0, f"{name}: D6 != plain version: {err}")
    S, slice_, grid = H.launch_config(B, n, H._CTAS[blocks.device.index])

    def call():
        H.histogram_call(blocks)

    def plain():
        H.histogram_blocks_ref(blocks)

    reps = 20 if B * n < 1 << 28 else 4
    ms, plain_ms = [], []
    for _ in range(rounds):  # kernel, plain, plain, kernel
        ms.append(cuda_ms(call, runs=5, reps=reps,
                          hold_cycles=HOLD_CYCLES)[0])
        plain_ms.append(cuda_ms(plain, runs=3, warmup=1)[0])
    ops = device_ops(call)
    row = {"B": B, "n": n, "slices": S, "slice": slice_, "grid": grid,
           "threads": H.THREADS, "max_abs_err": err, "ms": min(ms),
           "ms_turns": ms, "host_ms": host_ms(call),
           "device_ops": check_ops(ops, f"{name} histogram")}
    require(row["device_ops"]["kernels"] == 1,
            f"{name}: D6 issued {row['device_ops']['kernels']} kernels a call")
    row["kernel_ms"] = kernel_ms(ops)
    row["plain_ms"] = min(plain_ms)
    row["plain_ms_turns"] = plain_ms
    row["library_ms"] = row["plain_ms"]
    row.update(_bound(B * n + B * 256 * 8))
    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    return row


def histogram_shapes(data: np.ndarray, device="cuda") -> dict:
    """``histogram_row`` at every ``HIST_SHAPES`` shape on ``data`` (cycled
    where it is shorter), then the kernel alone at the throughput shape on
    each of ``HIST_PATTERNS`` side by side."""
    out = {}
    for name, (B, n) in HIST_SHAPES.items():
        blocks = torch.from_numpy(np.resize(data, B * n).reshape(B, n)).to(
            device)
        out[name] = histogram_row(name, blocks)
        del blocks
    B, n = HIST_SHAPES["throughput"]
    out["patterns"] = {}
    for kind in HIST_PATTERNS:
        blocks = hist_pattern(kind, B, n, device)
        require(_diff_counts(H.histogram_call(blocks),
                             H.histogram_blocks_ref(blocks)) == 0,
                f"{kind}: D6 != plain version")
        out["patterns"][kind] = kernel_ms(device_ops(
            lambda: H.histogram_call(blocks)))
        del blocks
    return out


# --- the crc kernel ------------------------------------------------------------

# (B, n1, n2) launch shapes: the parity cell's compress (its eight 16 MiB
# blocks) and one decode chunk (four blocks: R * k symbols, then k finals);
# the default point's 1,024 blocks of 128 KiB; one 4 KiB block
CRC_SHAPES = {"parity_compress": (8, 16 << 20, 0),
              "parity_decode_chunk": (4, (16 << 20) - 8192, 8192),
              "default": (1024, 128 << 10, 0), "graft": (1, 4096, 0)}


def crc_rows(B: int, n1: int, n2: int = 0, device="cuda", seed: int = 0xC3):
    """(rows (B, n1), tail (B, n2) or None) of uniform bytes on
    ``device``, made from ``seed``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.randint(0, 256, (B, n1), generator=g, dtype=torch.uint8)
    tail = (torch.randint(0, 256, (B, n2), generator=g, dtype=torch.uint8)
            if n2 else None)
    return rows.to(device), None if tail is None else tail.to(device)


def zlib_crcs(rows: torch.Tensor, tail=None) -> np.ndarray:
    """``zlib.crc32`` of each row (then its tail) on the host."""
    a = rows.cpu().numpy()
    b = None if tail is None else tail.cpu().numpy()
    return np.array([zlib.crc32(b[i], zlib.crc32(a[i])) if b is not None
                     else zlib.crc32(a[i]) for i in range(len(a))], np.uint32)


def _crc_diff(got: torch.Tensor, want: np.ndarray) -> int:
    """Rows whose crc differs."""
    return int((to_numpy(got) != want).sum())


def check_crc(device="cuda") -> dict:
    """The crc kernel against ``zlib.crc32`` and its plain version on the
    same tensors of ``device``, exactly: the parity cell's compress shape;
    n in {1, 15, 16, 17, 4,095, 4,097, 1 MiB + 3} at B in {1, 3}; the first
    row of a view at every storage offset 1..15; the two-piece form at one
    decode chunk of the parity cell and at odd lengths; B = 0 and no bytes
    (zeros, no launch). Each other case launches the kernel exactly
    once."""
    cases = [("parity_8x16MiB", *crc_rows(8, 16 << 20, 0, device))]
    cases += [(f"uniform_{B}x{n}", *crc_rows(B, n, 0, device, seed=B * n))
              for n in (1, 15, 16, 17, 4095, 4097, (1 << 20) + 3)
              for B in (1, 3)]
    flat, _ = crc_rows(1, 3 * 4099 + 16, 0, device)
    cases += [(f"offset_{off}", flat[0, off: off + 3 * 4099].view(3, 4099),
               None) for off in range(1, 16)]
    cases += [(f"pieces_{B}x{n1}+{n2}", *crc_rows(B, n1, n2, device,
                                                  seed=n1 + n2))
              for B, n1, n2 in ((4, (16 << 20) - 8192, 8192), (3, 17, 5),
                                (2, 0, 100), (2, 100_003, 300_007))]
    held = Held()
    for name, rows, tail in cases:
        before = K.CRC_LAUNCHES
        got = K.crc32_blocks(rows, tail)
        require(K.CRC_LAUNCHES == before + 1,
                f"{name}: {K.CRC_LAUNCHES - before} crc launches")
        want = zlib_crcs(rows, tail)
        held(_crc_diff(got, want), f"{name}: crc kernel != zlib.crc32")
        if rows.numel() + (0 if tail is None else tail.numel()) <= 1 << 24:
            held(_crc_diff(K.crc32_blocks_ref(rows, tail), want),
                 f"{name}: plain version != zlib.crc32")
    held(_crc_diff(K.crc32_blocks_ref(cases[0][1]), zlib_crcs(cases[0][1])),
         "parity: plain version != zlib.crc32")
    for shape in ((0, 16), (3, 0)):
        before = K.CRC_LAUNCHES
        got = K.crc32_blocks(torch.empty(shape, dtype=torch.uint8,
                                         device=device))
        require(K.CRC_LAUNCHES == before and got.shape == (shape[0],)
                and not bool(got.view(torch.int32).any()),
                f"{shape}: not zeros without a launch")
    return {"cases": len(cases) + 2, "max_abs_err": held.worst}


def crc_row(name: str, rows: torch.Tensor, tail=None,
            rounds: int = 2) -> dict:
    """The crc kernel at one launch shape: equal to ``zlib.crc32``; a
    wrapper call (CUDA events over queued calls behind a spin), the kernels
    alone (the profiler's device time of one call: the chunk kernel and the
    join, no memset or fill), the plain version on the same tensors and
    ``zlib.crc32`` on host copies (the host pass the kernel replaces, the
    yardstick) in turns, and the byte bound: the rows read once, 4 bytes a
    row written."""
    B, n1 = rows.shape
    n2 = 0 if tail is None else tail.shape[1]
    require(_crc_diff(K.crc32_blocks(rows, tail), zlib_crcs(rows, tail))
            == 0, f"{name}: crc kernel != zlib.crc32")
    host = np.ascontiguousarray(torch.cat(
        [rows, tail], 1).cpu().numpy() if n2 else rows.cpu().numpy())

    def call():
        K.crc32_blocks(rows, tail)

    def plain():
        K.crc32_blocks_ref(rows, tail)

    def on_host():
        for r in host:
            zlib.crc32(r)

    reps = 20 if B * (n1 + n2) < 1 << 28 else 4
    ms, plain_ms, zlib_ms = [], [], []
    for _ in range(rounds):  # kernel, plain, zlib, zlib, plain, kernel
        ms.append(cuda_ms(call, runs=5, reps=reps,
                          hold_cycles=HOLD_CYCLES)[0])
        plain_ms.append(cuda_ms(plain, runs=3, warmup=1)[0])
        zlib_ms.append(_host_ms(on_host))
    ops = device_ops(call)
    U = K.units(n1, n2)
    row = {"B": B, "n1": n1, "n2": n2, "units": U,
           "grid": min(B * U, K._CTAS[rows.device.index]),
           "threads": K.THREADS, "seg": K.SEG, "ms": min(ms),
           "ms_turns": ms, "host_ms": host_ms(call),
           "device_ops": check_ops(ops, f"{name} crc")}
    require(row["device_ops"]["kernels"] == 2,
            f"{name}: the crc issued {row['device_ops']['kernels']} kernels "
            "a call")
    row["kernel_ms"] = kernel_ms(ops)
    row["chunks_ms"] = kernel_ms(ops, "crc32_chunks")
    row["plain_ms"] = min(plain_ms)
    row["plain_ms_turns"] = plain_ms
    row["zlib_ms"] = min(zlib_ms)
    row["zlib_ms_turns"] = zlib_ms
    row.update(_bound(B * (n1 + n2) + 4 * B))
    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    return row


def crc_shapes(data: np.ndarray, device="cuda") -> dict:
    """``crc_row`` at every ``CRC_SHAPES`` shape on ``data`` (cycled where
    it is shorter)."""
    out = {}
    for name, (B, n1, n2) in CRC_SHAPES.items():
        flat = torch.from_numpy(np.resize(data, B * (n1 + n2))).to(device)
        rows = flat[: B * n1].view(B, n1)
        tail = flat[B * n1:].view(B, n2) if n2 else None
        out[name] = crc_row(name, rows, tail)
        del flat, rows, tail
    return out


# --- another commit's D3, B1 and layout kernels ------------------------------


def load_parent(old_root: Path) -> ctypes.CDLL:
    """Build ``old_root``'s ``tables.cu``, ``pl_decode.cu``,
    ``pl_decode_layout.cu`` and, where it has one, ``fse_coder.cu`` into a
    library of their own (one nvcc a source, started together, the current
    flags; ``kernels.build.compile_library``) and load it. ``lib.path`` is
    the library; ``lib.tables_half`` says whether its D3 launcher takes a
    half and a launch shape (else it builds both halves, one CTA a table),
    ``lib.layout_threads`` whether its layout launcher takes B1's CTA size
    and refill group, ``lib.fse`` whether it has D4/D5 and
    ``lib.fse_scratch`` whether their launchers take scratch in device
    memory (D4's slot bits and values and both kernels' final states, as
    the commit's wrapper allocated them)."""
    csrc = old_root / "entropy_coders_tpu_torch" / "csrc"
    srcs = [csrc / f"{n}.cu" for n in ("tables", "pl_decode",
                                       "pl_decode_layout")]
    fse = csrc / "fse_coder.cu"
    if fse.exists():
        srcs.append(fse)
    h = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(
        csrc.glob("*.cu*")))).hexdigest()[:16]
    out = KB.build_dir() / f"libect_torch_parent_{h}.so"
    if not out.exists():
        KB.writable_build_dir()
        KB.compile_library(srcs, out)
    lib = ctypes.CDLL(str(out))
    lib.path = out

    def head(src: Path, fn: str) -> str:
        text = src.read_text()
        text = text[text.index(f'extern "C" int {fn}('):]
        return text[: text.index(")")]

    lib.tables_half = "int half" in head(srcs[0], "ect_build_tables")
    lib.layout_threads = "int T" in head(srcs[2], "ect_pl_decode_layout")
    lib.fse = fse.exists()
    lib.fse_scratch = lib.fse and "sbits" in head(fse, "ect_fse_encode")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ect_build_tables.argtypes = (KB._SIGNATURES["ect_build_tables"]
                                     if lib.tables_half
                                     else [P] * 5 + [I, I, P])
    lib.ect_pl_decode.argtypes = KB._SIGNATURES["ect_pl_decode"]
    lib.ect_pl_decode_layout.argtypes = (
        KB._SIGNATURES["ect_pl_decode_layout"] if lib.layout_threads
        else [P] * 7 + [I] * 6 + [P])
    fns = [lib.ect_build_tables, lib.ect_pl_decode, lib.ect_pl_decode_layout]
    if lib.fse:
        LL = ctypes.c_longlong
        lib.ect_fse_decode.argtypes = (
            [P] * 10 + [I, LL, I, I, I, I, P] if lib.fse_scratch
            else KB._SIGNATURES["ect_fse_decode"])
        lib.ect_fse_encode.argtypes = (
            [P] * 13 + [I, I, I, I, I, LL, P] if lib.fse_scratch
            else KB._SIGNATURES["ect_fse_encode"])
        fns += [lib.ect_fse_decode, lib.ect_fse_encode]
    for fn in fns:
        fn.restype = ctypes.c_int
    return lib


def old_tables(lib, norm: torch.Tensor, L: int):
    """The other commit's D3 call, with what its wrapper did around it:
    (dec, tt_bits, tt_fs, next_state), both halves. A launcher without
    halves got four ``torch.empty`` outputs and a device guard."""
    B, dev = norm.shape[0], norm.device
    size = 1 << L
    dec = torch.empty((B, size), dtype=torch.int32, device=dev)
    tt_bits = torch.empty((B, 256), dtype=torch.int32, device=dev)
    tt_fs = torch.empty((B, 256), dtype=torch.int32, device=dev)
    nxt = torch.empty((B, size), dtype=torch.int16, device=dev)
    args = [norm.data_ptr(), dec.data_ptr(), nxt.data_ptr(),
            tt_bits.data_ptr(), tt_fs.data_ptr(), B, L]
    if lib.tables_half:
        args += [TB.HALVES["both"], *TB.launch_config(
            B, L, torch.cuda.get_device_properties(dev).multi_processor_count)]
    with torch.cuda.device(dev):
        _old_rc(lib.ect_build_tables(
            *args, torch.cuda.current_stream(dev).cuda_stream), "tables")
    return (dec.view(torch.uint32), tt_bits.view(torch.uint32), tt_fs,
            nxt.view(torch.uint16))


def current_kernels() -> ctypes.CDLL:
    """This commit's kernels' library, marked as ``load_parent`` marks
    another's, so that ``decode_with``/``layout_with`` call both commits'
    kernels the same way."""
    lib = KB.load()
    lib.path = KB.build()
    lib.tables_half = lib.layout_threads = lib.fse = True
    lib.fse_scratch = False
    return lib


def decode_with(lib, words, sizes, dec, L: int, R: int):
    """B1 of ``lib`` (``load_parent``, ``current_kernels``; a launcher
    that takes the CTA size and refill group) on one
    launch's tensors, the outputs ``torch.empty``: the same host work for
    either commit, so that their times in turns differ by the kernel."""
    B, W, k = words.shape
    dev = words.device
    out = (torch.empty((B, R, k), dtype=torch.uint8, device=dev),
           torch.empty((B, k), dtype=torch.uint8, device=dev),
           torch.empty((B, k), dtype=torch.int32, device=dev))
    _old_rc(lib.ect_pl_decode(
        words.data_ptr(), sizes.data_ptr(), dec.data_ptr(),
        *(o.data_ptr() for o in out), B, W, k, L, R,
        *PL.lane_config("decode", k, L),
        torch.cuda.current_stream(dev).cuda_stream), "decode")
    return out


def layout_with(lib, words, sizes, table, layout: str, L: int, R: int):
    """The layout kernel of ``lib`` on ``layout``'s planes, called as
    ``decode_with`` calls B1."""
    from . import l10_attack_harness as H

    B, W, k = words.shape
    dev = words.device
    out = (torch.empty((B, R, k), dtype=torch.uint8, device=dev),
           torch.empty((B, k), dtype=torch.uint8, device=dev),
           torch.empty((B, k), dtype=torch.int32, device=dev))
    pick = PL.lane_config("decode", k, L) if lib.layout_threads else ()
    _old_rc(lib.ect_pl_decode_layout(
        words.data_ptr(), sizes.data_ptr(), table[0].data_ptr(),
        table[1].data_ptr() if len(table) > 1 else None,
        *(o.data_ptr() for o in out), B, W, k, L, R, H.LAYOUTS.index(layout),
        *pick, torch.cuda.current_stream(dev).cuda_stream), "layout")
    return out


def main(argv=None) -> int:
    from .bench_data import gen_sequence

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="checkout of another commit")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweep", action="store_true",
                    help="D3 at every cluster and CTA size, then stop")
    ap.add_argument("--histogram", action="store_true",
                    help="D6's checks and launch shapes, then stop")
    ap.add_argument("--crc", action="store_true",
                    help="the crc kernel's checks and launch shapes, then "
                    "stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("device_host checks and times kernels on a CUDA "
                           "device; none here")
    if args.histogram:
        print(json.dumps({"check": "histogram", **check_histogram()}),
              flush=True)
        for name, row in histogram_shapes(gen_sequence(0.2, 128 << 20)).items():
            print(json.dumps({"shape": name, "histogram": row}), flush=True)
        return 0
    if args.crc:
        print(json.dumps({"check": "crc", **check_crc()}), flush=True)
        for name, row in crc_shapes(gen_sequence(0.2, 128 << 20)).items():
            print(json.dumps({"shape": name, "crc": row}), flush=True)
        return 0
    if args.sweep:
        for name, row in tables_sweep(gen_sequence(0.2, 128 << 20)).items():
            print(json.dumps({"sweep": name, **row}), flush=True)
        return 0
    old = load_old(args.old) if args.old is not None else None
    parent = load_parent(args.old) if args.old is not None else None
    print(json.dumps({"check": "repack", **check_repack()}), flush=True)
    print(json.dumps({"check": "tables", **check_tables()}), flush=True)
    data = gen_sequence(0.2, 128 << 20)
    for name in LS.SHAPES:
        inp = LS.shape_inputs(name, data)
        print(json.dumps({"shape": name, "repack": shape_repack(
            inp, name == "parity", old, args.rounds)}), flush=True)
        del inp
    for name, row in tables_shapes(data, parent).items():
        print(json.dumps({"shape": name, "tables": row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""D1-D3 on the card: the lane repack (``ops.device_repack``, kernels
``ect_lane_merge``/``ect_lane_split``) and the table build (``ops.tables``,
``ect_build_tables``) held against their plain PyTorch versions and against
the port's C++ host library, exactly, and timed at the main path's launch
shapes (``tools.lane_shapes.SHAPES``) beside their bounds and the C++ calls.

    python -m entropy_coders_tpu_torch.tools.device_host [--old DIR]
        [--rounds N]

prints one JSON line per check and per launch shape. ``chip_smoke.py``
drives the same functions in its phase ``device_host``. At each shape a
wrapper call of D1 and of D2 also runs once under ``torch.profiler``; the
device ops it issued are listed and must be at most two kernels and no
memset or fill. ``--old DIR`` names a checkout of another commit (e.g.
``git archive <commit> | tar -x -C build/parent``): its
``entropy_coders_tpu_torch/csrc/repack.cu`` is built into a library of its
own, and its merge and split, with what their wrapper did around them, are
timed against the current wrappers in turns (old, new, new, old;
``--rounds`` times), their outputs compared exactly. Its launchers are
either the first design's (PR 6: bit offsets in, a zeroed output; the
wrapper took ``lane_offsets`` and the zero fill) or the current ones.

A bound is the bytes the function must move over 3.35 TB/s (an H100 SXM's
published peak): each input read once, each output written once, counted
from this run's sizes. Merge: the payload read from the words and written
to the wire, plus 4 bytes of size a lane. Split: the payload read, 4 bytes
of size a lane and 8 of offset a block, every word row written. Tables: 1
KiB of counts read, 6 bytes a slot and 2 KiB of transforms written, a
block.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .. import native
from ..kernels import build as KB
from ..normalize import normalize_batch
from ..ops import device_repack as DR
from ..ops import tables as TB
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


def check_tables(device="cuda", seed: int = 0xD3) -> dict:
    """D3 against its plain version and against
    ``native.build_{encode,decode}_tables``, exactly: L = 5..15 at B = 4,
    B = 512 at L = 10, and B equal rows (the shared-table case). Raises
    AssertionError on any difference; ``max_abs_err`` is the largest
    difference measured over all compared tables."""
    rng = np.random.default_rng(seed)
    cases = [(L, 4, False) for L in range(5, 16)] + [(10, 512, False),
                                                     (11, 8, True)]
    low, held = 0, Held()
    for L, B, shared in cases:
        nt = table_counts(rng, 1 if shared else B, L)
        nt = np.repeat(nt, B, 0) if shared else nt
        low += int((nt == -1).sum())
        norm = torch.from_numpy(nt).to(device)
        got = TB.build_tables(norm, L)
        want = TB.build_tables_ref(norm, L)
        table, tt_bits, tt_fs = native.build_encode_tables(nt, L)
        cpp = (native.build_decode_tables(nt, L), tt_bits, tt_fs, table)
        for name, g, w, c in zip(("dec", "tt_bits", "tt_fs", "next_state"),
                                 got, want, cpp):
            held(_diff(g, w), f"{name} != plain version (L={L}, B={B})")
            held(_diff_host(g, c), f"{name} != C++ (L={L}, B={B})")
    require(low > 0, "no table with a -1 count")
    return {"cases": len(cases), "low_symbols": low,
            "max_abs_err": held.worst}


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


def shape_tables(inp: LS.ShapeInputs) -> dict:
    """D3 at one launch shape, on the normalized counts of the shape's
    blocks: equal to the C++ build and to its plain version
    (``max_abs_err``: the largest difference measured), and its time beside
    the plain version's, the C++ builds' and the bound."""
    B, L = inp.B, inp.L
    n = inp.blocks.shape[1]
    nt, logs = normalize_batch(histogram_blocks(inp.blocks).cpu().numpy(),
                               n, L)
    require((logs == L).all(), f"{inp.name}: table log raised above {L}")
    nt = TB.check_norm_tables(nt, L)
    norm = to_device(nt, inp.blocks.device)
    table, tt_bits, tt_fs = native.build_encode_tables(nt, L)
    want = (native.build_decode_tables(nt, L), tt_bits, tt_fs, table)
    held = Held()
    for g, p, w in zip(TB.build_tables(norm, L),
                       TB.build_tables_ref(norm, L), want):
        held(_diff_host(g, w), f"{inp.name}: D3 != the C++ tables")
        held(_diff(g, p), f"{inp.name}: D3 != plain version")

    def cpp():
        native.build_encode_tables(nt, L)
        native.build_decode_tables(nt, L)

    row = _in_turns(lambda: TB.build_tables(norm, L), cpp)
    row["plain_ms"] = cuda_ms(lambda: TB.build_tables_ref(norm, L), runs=2,
                              warmup=1)[0]
    row.update(_bound(B * (1024 + 6 * (1 << L) + 2048)),
               max_abs_err=held.worst)
    return {"B": B, "L": L, **row}


def main(argv=None) -> int:
    from .bench_data import gen_sequence

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="checkout of another commit")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("device_host checks and times kernels on a CUDA "
                           "device; none here")
    old = load_old(args.old) if args.old is not None else None
    print(json.dumps({"check": "repack", **check_repack()}), flush=True)
    print(json.dumps({"check": "tables", **check_tables()}), flush=True)
    data = gen_sequence(0.2, 128 << 20)
    for name in LS.SHAPES:
        inp = LS.shape_inputs(name, data)
        print(json.dumps({"shape": name, "repack": shape_repack(
            inp, name == "parity", old, args.rounds),
            "tables": shape_tables(inp)}), flush=True)
        del inp
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

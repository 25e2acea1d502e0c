"""On-card check of the PyTorch + CUDA port (``entropy_coders_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``entropy_coders_tpu_torch/csrc``, holds
each one against its plain PyTorch version on the card, then drives the
port's ``compress``/``decompress`` on ``device="cuda"`` through every golden
container frame and three 128 MiB operating points, and times the kernels.
Phase ``device_host`` holds the lane repack (D1 ``ect_lane_merge``, D2
``ect_lane_split``) and the table build (D3 ``ect_build_tables``) against
their plain versions and the port's C++ host library, exactly
(``tools.device_host``: both wire forms, k in {128, 1024, 8192, 16384},
zero-size and one-byte lanes, sizes on a word boundary, guard bits; D3 in
each half at L = 5..15 and every cluster size its wrapper can pick there,
tables with -1 counts, 512 tables, equal rows), and the per-block
histogram (D6 ``ect_histogram``) against its plain version where
histograms break (a constant, uniform, bench and bf16 pattern; n in {1,
15, 17, 4,097}; storage offsets 1..15; B = 0 and n = 0 give zeros without
a launch). The main path's D3
launches are checked exactly: one a table-log group a direction, 2 / 2 / 5
a round trip at the throughput / parity / default points and 33 with the
goldens; so are D4's and D5's (the shared-stream coder,
``ect_fse_encode`` / ``ect_fse_decode``: the default point's ragged tail
and the golden ``frame_pl_crc``'s, 3 each) and D6's (one a compress, none
on a decompress: 11), and no plain shared-stream core or plain histogram
(the ``bincount`` route) may run on a CUDA tensor. Phase ``routes``
runs the throughput, parity and default points with the repack on the card
and in C++ and with the tables built on the card and on the host, in turns,
wall times side by side, every frame's bytes and each route's launch counts
checked.
Phase ``timing`` times B1 and B2 on one and eight 16 MiB blocks and at the
main path's launch shapes (``tools.lane_shapes``: 4 blocks of 16 MiB at
the throughput and parity points, 512 blocks of 128 KiB at k=1024), each
launch held against the plain versions and its time printed beside its
bound (bytes over 3.35 TB/s against the busiest pipe's instructions, as
the kernels' SASS counts them, the larger), the chain under the card's
measured instruction latencies, and the share of the bound; D1-D3 are
timed at the same shapes on B2's real output (split of merge is the
identity) beside their byte bounds, their plain versions and the C++ calls
in turns; D3 at one chunk's and one lane group's launch shapes and at L =
15, each half on its own, beside the floor of an empty kernel launched the
same way (``tools.device_host.TABLE_SHAPES``). A wrapper call of D1 and of
D2 at each shape runs once under ``torch.profiler``: it must issue at most
two kernels and no memset or fill. D6 is timed at its launch shapes
(``tools.device_host.HIST_SHAPES``: 8 x 16 MiB, 1,024 x 128 KiB, a share of
8 virtual ranks at each, 256 x 4 MiB, one 4 KiB block), a wrapper call
behind a spin, the kernel alone (one kernel, no fill), the ``bincount``
route on the same tensor and the byte bound, the constant, uniform, bench
and bf16 patterns side by side. When ``build/parent`` holds a checkout
of an earlier commit (``git archive <commit> | tar -x -C build/parent``),
D1-D3 of that commit are timed in turns with the current ones through
what their wrappers did (``old_ms``), and B1 at each launch shape and B1
and every layout at L=10 through one call path for both commits, outputs
equal, with B1's SASS compared instruction by instruction; without it
``old_ms`` is null.
Phase ``lane_entries`` drives the JAX package's public lane entries
(``ops.encode_lanes`` / ``decode_lanes``, host numpy inputs, the tables
as ``(table, tt_bits, tt_fs)`` lists and packed rows from the port's host
library) at the three launch shapes: the encode equals its plain version
on the CPU on one block (``w_act`` included) and ``encode_call`` on the
same blocks and tables, trimmed the same way; the decode gives the input
back; a corrupted lane size raises ValueError; each call launches exactly
one B2 or B1. Each entry's host and CUDA-event times stand beside those
of the wrapper call it makes, on device-resident inputs. It runs after
the main path's launch counts are read.
Phase ``shared_stream`` (after ``lane_entries``) holds D4 and D5
(``csrc/fse_coder.cu``) against their plain versions on the same CUDA
tensors, exactly: k in {1, 2, 3, 4, 33, 127, 256, 777, 1000, 1024, 2000}
(the main path's two tail shapes among them), L in {5, 7, 8, 11, 12, 15},
blocks with tables of their own, padding slots, clean
round trips and seven corrupted or truncated decodes (all five outputs),
and the error words of ``checked=True`` (the plain checked versions'
messages). Then the 128 MiB data at 128 KiB blocks with ``lanes=False``
at k = 1024 and k = 2 (every block MODE_FSE): compress and decompress,
cold and warm, each frame's bytes and sha256 equal to the JAX package's
(``SHARED_STREAM``), one D4, D5 and two D3 launches a round trip and no
B1, B2, D1 or D2; D4 and D5 at each point's launch shape by CUDA events
(the launcher alone and a wrapper call) beside the bound, the larger of
the bytes over 3.35 TB/s and a floor of one round's dependent chain
under the card's measured latencies times the rounds; the wrappers
against the plain versions on the same CUDA tensors, exactly, at k = 1024
on the whole launch shape and at k = 2 on its first two blocks at all
65,535 rounds, each plain version's time beside the kernel's; with
``build/parent`` holding a checkout of a parent commit, its D4/D5 and
this commit's in turns at both launch shapes (old, new, new, old, outputs
equal); the peak device memory of one compress at each point; the
host's time in each ``ect.*`` stage (the MODE_FSE parts among them),
medians of three warm runs; the C++ host codec at k = 2. Then each kernel's registers, local memory,
resident CTAs an SM and round loop in the SASS at k = 1024 and 2, and the
k sweep: 1,024 blocks of 128 KiB at L = 11 for k in {1, 2, 4, 8, 32, 128,
1024}, every kernel that takes k (D5's one-thread, the one-warp and the
wide ones) against the wrapper and timed beside the bound, the wrappers
against the plain versions on the first block.
Phase ``layouts`` drives the decode table-layout tools
(``entropy_coders_tpu_torch.tools``, kernels B4/B5): ``l10_attack.run`` at
L=10 on the 128 MiB data and ``upack_hilog.run`` at L=11 and 13 (64 MiB,
and 128 MiB at L=13) check every layout against B1 and the input and time
it beside its CTAs per SM; each layout is then held against its plain
version on one block, exactly, and at L=10 also with a corrupted lane
size. Before the timing, phase ``entry_points`` drives the user entry
points on the card, each leg checking that B1 and B2 launched:

* ``stream``: 512 MiB through ``stream.compress_file`` /
  ``decompress_file`` at the library defaults (64 sub-frames): the file
  equals ``compress`` of the whole buffer and decodes back exactly;
* ``cli``: ``python -m entropy_coders_tpu_torch compress`` / ``decompress``
  / ``stat`` as subprocesses at the throughput point (61,729,231 bytes),
  ``warmup --mib 16`` beside them;
* ``checkpoint``: a bf16 ``state_dict`` of GPT-2 small's shapes (124.4 M
  parameters, random) through ``save_pytree`` / ``load_pytree``, bit for
  bit; ``Checkpoint.load_leaf`` decodes only its leaf's blocks; the file's
  frame equals ``compress`` of the payload; the ``ckpt_small`` golden is
  written and read without ``ml_dtypes``;
* ``pipeline``: the throughput point with the chunk pipeline and with one
  chunk at a time, in turns, wall times side by side.

Phase ``trace`` runs one compress plus decompress at the throughput and at
the default point under ``utils.trace`` (``torch.profiler``) and prints the
device time it saw beside the wall time, the five device ops that took the
most, and the host's wall time in each stage of ``frame.compress`` /
``decompress`` (their ``ect.*`` profiler ranges), on the container's route
and with the C++ repack; the throughput round trip must show D6 once and
no point CUDA's ``bincount`` (``kernelHistogram1D``). Phase ``configs`` (after ``lane_entries``)
runs the root scripts' measurements on the port
(``tools.bench_configs``, ``tools.policy_sweep``) at the JAX sizes,
nothing cut: configs 1-6 (config 4 on ``default_mesh()``, every card)
and the table-log policy sweep, one build of each corpus shared, every
result line and each corpus's sha256 printed (the text corpora follow
the tree's root files); every round trip exact, config 6's ratios of
geo, bf16 and jsonlog as BASELINE.md gives them to 4 places, each
decode-rate timer call's B1 launches as the timer counted them; then
B1's rate at L = 8 on each corpus beside the sweep's per-L rates on geo,
and the same frames retaken in turns, with and without the spin that
hides the host's launches. Phase ``bench`` (after ``configs``) runs the
root ``bench.py``'s counterpart, ``python -m
entropy_coders_tpu_torch.tools.bench``, as a subprocess (a fresh
process's cold start, the libraries already built): its two lines must
say ``"backend": "cuda"``, frames of 61,729,231 and 60,779,273 bytes and
a parity ratio at or under 0.4530 (the bench itself holds B1's and B2's
outputs exactly against the frames before it times them, one call over
all eight 16 MiB blocks); both lines are printed beside the card. It
then takes over ``tests/tpu_smoke.py``'s big-block check: (512 KiB + 321)
bytes at k=8192, per-lane, compressed on the card, equal byte for byte
to the same compress on the CPU's plain versions, and round-tripped.
Phase ``graft`` runs the root ``__graft_entry__.py``'s counterpart
(``tools.graft_entry``): ``entry("cuda")``'s four outputs equal
``entry("cpu")``'s, the block round-trips through the same cores, and
``dryrun_multichip`` passes over every card and over four virtual ranks
of card 0, its frames equal byte for byte to the plain versions' on the
CPU at the knobs the card resolves (``lanes`` unset is per-lane on CUDA,
as on the JAX package's TPU). Then it
drives the multi-device path (``entropy_coders_tpu_torch.parallel``):

* ``ring``: B3 against its plain version on virtual ranks, a mesh that
  names ``cuda:0`` n times, for n in {2, 3, 8}: int32 chunks of 16-byte
  vectors and of 4-byte words, float32 chunks and the histogram
  all-reduce of the 128 MiB data's counts, every rank's output and
  accumulator compared exactly; then ``ring_all_gather`` at n = 8 of the
  throughput point's lane words, one (264, 16384) u32 block per rank,
  checked and timed by CUDA events beside the plain version and the
  bound, (n + n*n) * chunk over 3.35 TB/s; a ``torch.profiler`` window of
  calls after the mesh's first shows B3's kernel only (no memset, fill or
  set-up call) and its device time, and the host's part of a call (the
  wrapper's and the launcher's time to return) is timed apart. With two cards or more it prints the
  peer-access matrix and ``nvidia-smi topo -m``, runs the same cases on
  peer ranks (distinct GPUs) at n = 2 and n = all cards, two full-width
  calls on the mesh's cached state and one of another chunk size, and
  times the full-width ring by each card's CUDA events (the slowest) and
  the host clock beside its NVLink bound, (n-1) * chunk over 450 GB/s;
  then, as B3's yardstick, NCCL's ``all_gather_into_tensor`` of the same
  per-rank chunk, one process a card (this script run with
  ``--nccl-worker``), by CUDA events and the host clock.
* ``sharded``: first the shared-stream (MODE_FSE) groups on a mesh, the
  128 MiB data at 128 KiB blocks, k = 1024, ``lanes=False``: the
  unsharded frame is the JAX package's (sha256); a round trip on eight
  virtual ranks launches D3, D4 and D5 once a share a direction and
  nothing else, runs no plain core on a CUDA tensor, and nothing inside
  a MODE_FSE dispatch waits for the card (``torch.cuda``'s sync debug
  mode); the unsharded call, the eight ranks and ``default_mesh()`` in
  turns, beside the parent commit's port on the same meshes when
  ``build/parent`` holds it, each one's compress peak device memory; 5
  blocks over 8 ranks, a range decode, and a missing marker (at the last
  share's dispatch) and a flipped byte (at its drain) raising
  ValueError, each followed by an exact decode; with two cards or more,
  one card against all of them, the parent beside. Then the throughput
  point through ``compress`` without a sharding, ``parallel.compress`` / ``decompress`` on eight virtual ranks
  and on ``default_mesh()``, in turns (a warm-up round, then three, the
  order reversed every other round; medians), and 5 blocks over 8 ranks:
  each frame equals ``compress``'s, byte for byte, and round-trips; with
  ``shared_table=True`` the sharded histogram, the ring's all-reduce of
  the per-rank counts and ``np.bincount`` agree, and the header they
  normalise to is the one the frame carries. A compress on the eight
  ranks launches D6 once a share, and nothing inside a share's
  histogram waits for the card (the sync watch, with its ``.item()``
  control). With two cards or more,
  ``default_mesh(1)`` against ``default_mesh()`` in turns at the
  throughput point and at 1 GiB in config 4's shape (BASELINE.md: shared
  table, 4 MiB blocks, k=8192, the default table-log policy), every frame
  equal to the one-card frame; then each mesh's compress and decompress
  once under ``torch.profiler``: each card's device window (first to
  last kernel or copy) and the windows' union against their sum.
* ``multihost``: two worker processes on the card (this script run with
  ``--multihost-worker``, gloo on 127.0.0.1) compress and decompress the
  128 MiB data through ``parallel.multihost``, plain and with
  ``shared_table``, ``bit_pack`` and ``checksum``; each prints the frames'
  sha256, which must equal the single-process frames', its owned range
  (``assemble=False``) and its own kernel launch counts.

Each phase prints one JSON line. The line before the last lists the
kernels; the last line is ``{"ok": true, "device": {...}}``, printed only
when every phase passed. Any failure exits non-zero without it, as does a
machine without CUDA or a directory without the repository.

Test data comes from ``tests/data/generate_golden.py`` (its data
generators import neither JAX nor the JAX package). Nothing of JAX and
nothing of the JAX package is imported: the port builds its own C++ host
library (``entropy_coders_tpu_torch.native``) beside its kernels.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import importlib.util
import json
import re
import socket
import statistics
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MIB = 1 << 20
BENCH_SIZE = 128 * MIB
BENCH_SEED = 0xF5E
THROUGHPUT_BYTES = 61_729_231  # 16 MiB blocks, k=16384, table_log 8
PARITY_BYTES = 60_779_273      # k=8192, table_log 11, bit_pack
REFERENCE_RATIO = 0.4530       # the reference Rust frame on this corpus
BLOCK = 16 * MIB
THROUGHPUT = dict(block_size=BLOCK, k=16384, table_log=8, lanes=True)
MULTIHOST_LEGS = {"plain": {},
                  "shared": dict(shared_table=True, bit_pack=True,
                                 checksum=True)}
# config 4 of BASELINE.md (enwik9 on one host, shared table, mesh-sharded
# blocks) at 1 GiB of the bench distribution: 4 MiB blocks, k=8192, the
# default table-log policy
CONFIG4_BYTES = 1 << 30
CONFIG4 = dict(block_size=4 * MIB, k=8192, shared_table=True, lanes=True)
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's published peak
NVLINK_BYTES_PER_S = 450e9  # one H100 SXM's NVLink, each way


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def load_testdata():
    spec = importlib.util.spec_from_file_location(
        "generate_golden", ROOT / "tests" / "data" / "generate_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_ms(fn, devices, runs: int = 7, warmup: int = 2):
    """Median host-clock time of ``fn`` in ms, every device in ``devices``
    synchronised before and after each run (work on several cards, which
    one card's events cannot bracket)."""
    import torch

    def sync():
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def max_abs_diff(a, b) -> int:
    """Largest |a - b| over two integer tensors of one shape (any int
    type, compared by value)."""
    from entropy_coders_tpu_torch.ops.unsigned import as_int64

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((as_int64(a) - as_int64(b)).abs().max())


# --- phases -----------------------------------------------------------------


def phase_env():
    import torch

    from entropy_coders_tpu_torch import native
    from entropy_coders_tpu_torch.kernels import build as KB
    from entropy_coders_tpu_torch.native import build as NB

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    cards = smi.stdout.strip().splitlines()
    card = cards[0] if cards else ""
    print(card, flush=True)  # the card's name and power limit, as-is
    t0 = time.perf_counter()
    KB.load()
    load_s = time.perf_counter() - t0
    print(KB.last_build["log"], file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    native.load()  # raises with g++'s output when the build fails
    host_load_s = time.perf_counter() - t0
    emit("env", card=card, cards=cards, torch=torch.__version__,
         cuda=torch.version.cuda,
         python=sys.version.split()[0],
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         kernel_build_s=KB.last_build["seconds"], kernel_load_s=load_s,
         host_library_build_s=NB.last_build["seconds"],
         host_library_load_s=host_load_s,
         host_library=NB.library_path().name)
    return card


def _case_blocks(rng, B, n, alphabet):
    import numpy as np

    if alphabet == "geo":  # geometric: a dominant symbol, count > 256
        return (rng.geometric(0.2, (B, n)) - 1).clip(0, 255).astype(np.uint8)
    return rng.integers(0, alphabet, (B, n)).astype(np.uint8)


def compare_lanes(blocks_np, L, k, device="cuda", time_kernels=False):
    """Encode and decode ``blocks_np`` (B, (R+1)k) with the kernels and the
    plain versions on the same CUDA tensors; return the largest output
    difference and, when asked, the kernels' median times in ms (each run
    ``LS.REPS`` launches queued back to back)."""
    import numpy as np
    import torch

    from entropy_coders_tpu_torch.normalize import normalize_batch
    from entropy_coders_tpu_torch.ops import pl_coder as PL
    from entropy_coders_tpu_torch.tools import lane_shapes as LS
    from entropy_coders_tpu_torch.tools.bench_data import cuda_ms

    B, n = blocks_np.shape
    R = n // k - 1
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks_np])
    nt, l2 = normalize_batch(counts, n, L)
    check((l2 == L).all(), f"table log raised to {l2} (L={L})")
    W = PL.encode_w_bound(R, L)
    tabs = PL.tables_from_norm(nt, L, device)
    blocks = torch.from_numpy(blocks_np).to(device)

    words, sizes = PL.encode_call(blocks, tabs, k=k, L=L, W=W)
    rwords, rsizes = PL.encode_call_ref(blocks, tabs, k=k, L=L, W=W)
    syms, finals, cur = PL.decode_call(words, sizes, tabs.dec, L=L, R=R)
    rsyms, rfinals, rcur = PL.decode_call_ref(words, sizes, tabs.dec, L=L,
                                              R=R)
    torch.cuda.synchronize()
    err = max(max_abs_diff(words, rwords), max_abs_diff(sizes, rsizes),
              max_abs_diff(syms, rsyms), max_abs_diff(finals, rfinals),
              max_abs_diff(cur, rcur))
    check(err == 0, f"kernel != plain version (L={L}, k={k}, R={R}): {err}")
    check(not bool((cur != 0).any()), "cursors not drained on a valid stream")
    got = torch.cat([syms.reshape(B, -1), finals], 1).cpu().numpy()
    check((got == blocks_np).all(), f"round trip failed (L={L}, k={k})")
    out = {"L": L, "k": k, "R": R, "B": B, "max_abs_err": err,
           "max_count": int(nt.max()), "symbols": int((counts > 0).sum(1).max())}
    if time_kernels:
        out["encode_ms"], _ = cuda_ms(
            lambda: PL.encode_call(blocks, tabs, k=k, L=L, W=W),
            reps=LS.REPS)
        out["decode_ms"], _ = cuda_ms(
            lambda: PL.decode_call(words, sizes, tabs.dec, L=L, R=R),
            reps=LS.REPS)
        out["encode_GBps"] = n * B / out["encode_ms"] / 1e6
        out["decode_GBps"] = n * B / out["decode_ms"] / 1e6
    return out


def phase_kernels():
    import numpy as np
    import torch

    from entropy_coders_tpu_torch.normalize import normalize_batch
    from entropy_coders_tpu_torch.ops import pl_coder as PL

    rng = np.random.default_rng(BENCH_SEED)
    # a covering set, not the cross product: every L, k in {128, 8192},
    # R in {1, 17, 1023}, symbols < 128 and all 256, a count > 256
    cases = [(5, 128, 17, 2, 16), (8, 8192, 1023, 1, 64),
             (11, 8192, 1, 2, 256), (13, 128, 1023, 2, "geo"),
             (15, 8192, 17, 1, 256)]
    results, worst = [], 0
    for L, k, R, B, alphabet in cases:
        res = compare_lanes(_case_blocks(rng, B, (R + 1) * k, alphabet), L, k)
        results.append(res)
        worst = max(worst, res["max_abs_err"])
    check(any(r["max_count"] > 256 for r in results), "no count > 256 case")
    check(any(r["symbols"] > 128 for r in results), "no > 128-symbol case")

    # a corrupt stream: one lane's size pushed past anything R rounds can
    # consume, so its cursor cannot drain
    blocks_np = _case_blocks(rng, 1, 18 * 128, "geo")
    counts = np.bincount(blocks_np[0], minlength=256)[None]
    nt, l2 = normalize_batch(counts, blocks_np.shape[1], 11)
    L = int(l2[0])
    words, sizes = PL.encode_lanes_norm(
        torch.from_numpy(blocks_np).cuda(), nt, k=128, L=L,
        W=PL.encode_w_bound(17, L))
    bad = sizes.clone()
    bad[0, 3] ^= 0x4000
    try:
        PL.decode_lanes_norm(words.contiguous(), bad, nt, k=128, L=L, R=17)
        raise SmokeFailure("corrupt stream decoded without ValueError")
    except ValueError:
        pass
    emit("kernels", cases=results, corrupt_raises=True, max_abs_err=worst)
    return worst


def phase_device_host():
    """D1-D3 against their plain versions on the card and against the
    port's C++ host library, exactly, D6 against its plain version where
    histograms break, and the crc kernel against ``zlib.crc32`` and its
    plain version at the parity shape, at odd lengths and in the two-piece
    form (``tools.device_host``). Returns the largest difference measured,
    of the repack, of the tables, of the histogram and of the crc."""
    from entropy_coders_tpu_torch.tools import device_host as DH

    t0 = time.perf_counter()
    repack = DH.check_repack()
    tables = DH.check_tables()
    histogram = DH.check_histogram()
    crc = DH.check_crc()
    emit("device_host", repack=repack, tables=tables, histogram=histogram,
         crc=crc, seconds=time.perf_counter() - t0)
    return {"repack": repack["max_abs_err"], "tables": tables["max_abs_err"],
            "histogram": histogram["max_abs_err"],
            "crc": crc["max_abs_err"]}


def phase_goldens(T, gg):
    import numpy as np

    manifest = json.loads(
        (ROOT / "tests" / "data" / "golden" / "manifest.json").read_text())
    names = []
    for case in manifest:
        if case["codec"] != "frame":
            continue
        spec = case["input"]
        data = (gg.make_mixed(spec["size"], spec["seed"])
                if spec["kind"] == "mixed_rle_raw" else gg.make_input(spec))
        kw = {kk: case[kk] for kk in ("block_size", "k", "lanes",
                                      "shared_table", "checksum",
                                      "table_log", "bit_pack") if kk in case}
        frame = T.compress(np.asarray(data), device="cuda", **kw)
        check(hashlib.sha256(frame).hexdigest() == case["sha256"],
              f"golden {case['name']}: frame sha256 differs")
        golden = (ROOT / "tests" / "data" / "golden" / case["file"]).read_bytes()
        check(T.decompress(golden, device="cuda") == data.tobytes(),
              f"golden {case['name']}: decode differs")
        names.append(case["name"])
    check(len(names) >= 5, "fewer than 5 frame goldens")
    emit("goldens", reproduced=names)


def _launch_counts_all():
    """The launch counts of B1, B2, D1-D3, D4/D5, D6 and the crc as they
    stand."""
    from entropy_coders_tpu_torch.ops import coder as C
    from entropy_coders_tpu_torch.ops import crc as K
    from entropy_coders_tpu_torch.ops import histogram as H
    from entropy_coders_tpu_torch.ops import pl_coder as PL

    return {"decode": PL.DECODE_LAUNCHES, "encode": PL.ENCODE_LAUNCHES,
            **_device_host_counts(), "fse_encode": C.ENCODE_LAUNCHES,
            "fse_decode": C.DECODE_LAUNCHES, "histogram": H.HIST_LAUNCHES,
            "crc": K.CRC_LAUNCHES}


@contextlib.contextmanager
def plain_cores_on_cuda(counts: dict):
    """While open, every call of the shared-stream cores' plain versions
    (``ops.coder.encode_core_ref``/``decode_core_ref``), of D6's
    (``ops.histogram.histogram_blocks_ref``, the ``bincount`` route) and of
    the crc's (``ops.crc.crc32_blocks_ref``) on CUDA tensors adds one to
    ``counts``: the wrappers must never take them there."""
    from entropy_coders_tpu_torch.ops import coder as C
    from entropy_coders_tpu_torch.ops import crc as K
    from entropy_coders_tpu_torch.ops import histogram as H

    saved = (C.encode_core_ref, C.decode_core_ref, H.histogram_blocks_ref,
             K.crc32_blocks_ref)

    def counted(name, fn):
        def call(first, *args, **kwargs):
            if first.device.type == "cuda":
                counts[name] = counts.get(name, 0) + 1
            return fn(first, *args, **kwargs)
        return call

    C.encode_core_ref = counted("encode_core_ref", saved[0])
    C.decode_core_ref = counted("decode_core_ref", saved[1])
    H.histogram_blocks_ref = counted("histogram_blocks_ref", saved[2])
    K.crc32_blocks_ref = counted("crc32_blocks_ref", saved[3])
    try:
        yield counts
    finally:
        (C.encode_core_ref, C.decode_core_ref, H.histogram_blocks_ref,
         K.crc32_blocks_ref) = saved


def roundtrip(T, data, **kw):
    """compress + decompress twice each (cold, then warm); the round trip
    is asserted. Returns (frame, timings); the timings carry every
    kernel's launches of one compress + decompress."""
    import torch

    from entropy_coders_tpu_torch.ops import histogram as H

    times = {}
    c0 = _launch_counts_all()
    for tag in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = T.compress(data, device="cuda", **kw)
        times[f"compress_s_{tag}"] = time.perf_counter() - t0
        h0 = H.HIST_LAUNCHES
        t0 = time.perf_counter()
        out = T.decompress(frame, device="cuda")
        torch.cuda.synchronize()
        times[f"decompress_s_{tag}"] = time.perf_counter() - t0
        check(out == data.tobytes(), f"round trip failed ({kw})")
        check(H.HIST_LAUNCHES == h0, f"a decompress launched D6 ({kw})")
    times["launches"] = {k: (v - c0[k]) // 2
                         for k, v in _launch_counts_all().items()}
    return frame, times


# D3 launches a 128 MiB round trip: one a table-log group a direction, the
# per-lane groups' and the shared-stream (MODE_FSE) groups' (the default
# point's uniform block is a table-log group of its own on compress, then
# stored RAW; its 777-byte tail is a MODE_FSE group, k = 777); with the five
# golden frames' 15, the main path's 33
D3_LAUNCHES = {"throughput": 2, "parity": 2, "default": 5}
D3_MAIN_PATH = 15 + 2 * sum(D3_LAUNCHES.values())
# D4 and D5 launches a round trip, each: one a MODE_FSE group a direction
# (the default point's tail); with the golden frame_pl_crc's tail, 3 each
FSE_LAUNCHES = {"throughput": 0, "parity": 0, "default": 1}
FSE_MAIN_PATH = 1 + 2 * sum(FSE_LAUNCHES.values())
# D6 launches a round trip: one a compress of full blocks (one share
# unsharded; a decompress launches none); with the five golden frames'
# compresses (each has a full block), the main path's 11
D6_LAUNCHES = {"throughput": 1, "parity": 1, "default": 1}
D6_MAIN_PATH = 5 + 2 * sum(D6_LAUNCHES.values())
# crc launches on the main path: the two golden frames with crcs
# (frame_pl_crc, frame_packed_crc), one a compress (one share of full
# blocks) and one a decompress (one per-lane group of one chunk); the three
# points' frames carry no crc
CRC_MAIN_PATH = 4


def check_d3_launches(name, launches):
    check(launches["tables"] == D3_LAUNCHES[name],
          f"{name}: {launches['tables']} D3 launches a round trip, "
          f"expected {D3_LAUNCHES[name]} (one a table-log group a "
          f"direction)")
    for kind in ("fse_encode", "fse_decode"):
        check(launches[kind] == FSE_LAUNCHES[name],
              f"{name}: {launches[kind]} {kind} (D4/D5) launches a round "
              f"trip, expected {FSE_LAUNCHES[name]}")
    check(launches["histogram"] == D6_LAUNCHES[name],
          f"{name}: {launches['histogram']} D6 launches a round trip, "
          f"expected {D6_LAUNCHES[name]} (one a compress)")


def phase_point(T, name, data, expect_bytes, **kw):
    frame, times = roundtrip(T, data, **kw)
    check_d3_launches(name, times["launches"])
    check(len(frame) == expect_bytes,
          f"{name}: frame is {len(frame)} bytes, expected {expect_bytes}")
    ratio = len(frame) / len(data)
    emit(name, frame_bytes=len(frame), ratio=ratio, input_bytes=len(data),
         knobs={k: v for k, v in kw.items()},
         compress_GBps=len(data) / times["compress_s_warm"] / 1e9,
         decompress_GBps=len(data) / times["decompress_s_warm"] / 1e9,
         **times)
    return ratio, frame


def default_data(gen_sequence):
    """The default point's input: 128 MiB + 777 bytes with a constant block
    (RLE), a uniform block (RAW) and a ragged tail (shared-stream
    MODE_FSE)."""
    import numpy as np

    from entropy_coders_tpu_torch import frame as TF

    data = gen_sequence(0.2, BENCH_SIZE + 777, BENCH_SEED + 1)
    bs = TF.DEFAULT_BLOCK_SIZE
    data[3 * bs: 4 * bs] = 7
    data[5 * bs: 6 * bs] = np.random.default_rng(5).integers(
        0, 256, bs, dtype=np.uint8)
    return data


def phase_default(T, data):
    """128 MiB at the library defaults (128 KiB blocks, k=1024, the
    ("fast", 0.0025) policy) on ``default_data``. Returns the frame."""
    from entropy_coders_tpu_torch import frame as TF

    bs = TF.DEFAULT_BLOCK_SIZE
    frame, times = roundtrip(T, data)
    check_d3_launches("default", times["launches"])
    pf = TF._parse_frame(frame)
    modes = {name: int((pf.modes == m).sum()) for name, m in
             (("fse_pl", TF.MODE_FSE_PL), ("fse", TF.MODE_FSE),
              ("raw", TF.MODE_RAW), ("rle", TF.MODE_RLE))}
    check(min(modes.values()) >= 1,
          f"default point missed a block mode: {modes}")
    emit("default", frame_bytes=len(frame), ratio=len(frame) / len(data),
         input_bytes=len(data), modes=modes, block_size=bs, k=TF.DEFAULT_K,
         **times)
    return frame


# --- the repack and table routes, in turns ---------------------------------------

# route -> (frame._DEVICE_REPACK, PL.HOST_TABLES_ON_CUDA); None leaves the
# switch as the package sets it, so "device" is the route a user gets
ROUTES = {"device": (None, None), "cpp_repack": (False, None),
          "host_tables": (None, True)}


def _device_host_counts():
    from entropy_coders_tpu_torch.ops import device_repack as DR
    from entropy_coders_tpu_torch.ops import tables as TB

    return {"merge": DR.MERGE_LAUNCHES, "split": DR.SPLIT_LAUNCHES,
            "tables": TB.TABLE_LAUNCHES}


@contextlib.contextmanager
def stage_clocks(spent: dict):
    """While open, the ``ect.*`` ranges of ``frame`` and of
    ``pl_coder.tables_from_norm`` add their host time to ``spent`` (stage
    -> seconds) in place of profiler ranges."""
    from entropy_coders_tpu_torch import frame as TF
    from entropy_coders_tpu_torch.ops import pl_coder as PL

    @contextlib.contextmanager
    def clock(stage):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            spent[stage] = spent.get(stage, 0.0) + time.perf_counter() - t0

    saved = TF._stage, PL.record_function
    TF._stage = PL.record_function = clock
    try:
        yield spent
    finally:
        TF._stage, PL.record_function = saved


def phase_routes(T, PL, points, rounds: int = 3):
    """Each point of ``points`` (name -> (data, knobs, the expected frame))
    through three routes in turns (``device``: no switch forced, the
    container's own route, which must put repack and tables on the card; ``cpp_repack``:
    the C++ repack forced; ``host_tables``: tables built on the host and
    copied, forced): device, cpp_repack, host_tables, then the reverse,
    ``rounds`` times. Host-clock wall times, each run ending synchronised, and the
    host's time in each stage of ``frame.compress``/``decompress`` (their
    ``ect.*`` ranges, clocked here; ``ect.compress.tables`` and
    ``ect.decompress.tables`` lie inside the dispatch stages); every frame
    equal to the expected one and every round trip exact; a route's launch
    counts must show its kernels and none of the others'."""
    import torch

    from entropy_coders_tpu_torch import frame as TF

    spent = {}
    order = [*ROUTES, *reversed(ROUTES)] * rounds
    saved = (TF._DEVICE_REPACK, PL.HOST_TABLES_ON_CUDA)
    check(saved[0] is None, "routes: a repack switch is already forced")
    out = {}
    try:
        # the stage ranges feed a host clock here, where no profiler listens
        with stage_clocks(spent):
            for name, (data, knobs, want) in points.items():
                times = {r: {"compress_s": [], "decompress_s": [], "stages": []}
                         for r in ROUTES}
                launches = {}
                for route in order:
                    repack, host_tables = ROUTES[route]
                    TF._DEVICE_REPACK = saved[0] if repack is None else repack
                    PL.HOST_TABLES_ON_CUDA = (saved[1] if host_tables is None
                                              else host_tables)
                    spent.clear()
                    c0 = _device_host_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    frame = T.compress(data, device="cuda", **knobs)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    back = T.decompress(frame, device="cuda")
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    got = {k: v - c0[k] for k, v in _device_host_counts().items()}
                    check(frame == want, f"routes: {name} frame differs on "
                          f"route {route}")
                    check(back == data.tobytes(), f"routes: {name} round trip "
                          f"on route {route}")
                    check((got["merge"] > 0) == (repack is None)
                          and (got["split"] > 0) == (repack is None)
                          and (got["tables"] > 0) == (host_tables is None),
                          f"routes: {name} on route {route} launched {got}")
                    launches[route] = got
                    times[route]["compress_s"].append(t1 - t0)
                    times[route]["decompress_s"].append(t2 - t1)
                    times[route]["stages"].append(dict(spent))
                for r in times:
                    for k in ("compress_s", "decompress_s"):
                        times[r][k.replace("_s", "_median_s")] = \
                            statistics.median(times[r][k])
                    runs = times[r].pop("stages")
                    times[r]["stage_median_ms"] = {
                        st: statistics.median(x.get(st, 0.0) for x in runs) * 1e3
                        for st in sorted(set().union(*runs))}
                out[name] = {"frame_bytes": len(want), "order": order,
                             "launches": launches, **times}
    finally:
        TF._DEVICE_REPACK, PL.HOST_TABLES_ON_CUDA = saved
    emit("routes", **out)
    return out


# --- the user entry points (stream, CLI, checkpoints) and the pipeline ------------


def _sha(b) -> str:
    return hashlib.sha256(b).hexdigest()


def _launch_counts(PL):
    return PL.ENCODE_LAUNCHES, PL.DECODE_LAUNCHES


def entry_stream(T, PL, data, tmp):
    """``data`` (512 MiB of the bench distribution) through
    ``compress_file`` / ``decompress_file`` at the library defaults (128
    KiB blocks, k=1024, ``chunk_blocks=64``: 64 sub-frames of 8 MiB): the
    file equals ``compress`` of the whole buffer and decodes back exactly.
    Returns (results, the whole-buffer frame's length)."""
    import numpy as np
    import torch

    from entropy_coders_tpu_torch import stream as S

    src, dst, back = tmp / "s.bin", tmp / "s.fset", tmp / "s.out"
    data.tofile(src)
    e0, d0 = _launch_counts(PL)
    t0 = time.perf_counter()
    n_out = S.compress_file(src, dst, device="cuda")
    compress_s = time.perf_counter() - t0
    e1, _ = _launch_counts(PL)
    t0 = time.perf_counter()
    n_back = S.decompress_file(dst, back, device="cuda")
    torch.cuda.synchronize()
    decompress_s = time.perf_counter() - t0
    _, d1 = _launch_counts(PL)
    check(n_back == len(data) and (np.fromfile(back, np.uint8) == data).all(),
          "stream: decompress_file did not give back the input")
    whole = T.compress(data, device="cuda")
    check(_sha(dst.read_bytes()) == _sha(whole) and n_out == len(whole),
          "stream: compress_file's file != compress of the whole buffer")
    check(e1 > e0 and d1 > d0, f"stream: a kernel never launched "
          f"(encode {e1 - e0}, decode {d1 - d0})")
    return {"input_bytes": len(data), "file_bytes": n_out,
            "sub_frames": -(-len(data) // (64 * (128 << 10))),
            "compress_s": compress_s, "decompress_s": decompress_s,
            "compress_GBps": len(data) / compress_s / 1e9,
            "decompress_GBps": len(data) / decompress_s / 1e9,
            "launches": {"encode": e1 - e0, "decode": d1 - d0}}, len(whole)


def _cli(*args):
    """Start ``python -m entropy_coders_tpu_torch`` with ``args``."""
    return subprocess.Popen(
        [sys.executable, "-m", "entropy_coders_tpu_torch", *map(str, args)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _cli_done(p, what, timeout=600):
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        raise SmokeFailure(f"cli {what} timed out")
    check(p.returncode == 0, f"cli {what} failed ({p.returncode}):\n"
          f"{err[-4000:]}")
    return out, err


def _cli_launches(err: str, what: str):
    """The CLI's own report of its kernel launches (stderr)."""
    import re

    m = re.search(r"kernel launches: encode (\d+), decode (\d+)", err)
    check(m is not None, f"cli {what}: no launch report in {err[-500:]!r}")
    return int(m.group(1)), int(m.group(2))


def entry_cli(data, tmp):
    """The CLI as a subprocess on the 128 MiB bench data at the throughput
    point's flags, with ``warmup --mib 16`` beside it."""
    src, comp, back = tmp / "c.bin", tmp / "c.fset", tmp / "c.out"
    data.tofile(src)
    procs = []

    def start(*args):
        procs.append(_cli(*args))
        return procs[-1]

    t0 = time.perf_counter()
    try:
        warm = start("warmup", "--mib", 16)
        t1 = time.perf_counter()
        _, err = _cli_done(start(
            "compress", src, comp, "--block-size", THROUGHPUT["block_size"],
            "--k", THROUGHPUT["k"], "--table-log", THROUGHPUT["table_log"]),
            "compress")
        compress_s = time.perf_counter() - t1
        enc, _ = _cli_launches(err, "compress")
        size = comp.stat().st_size
        check(size == THROUGHPUT_BYTES, f"cli: compress wrote {size} bytes, "
              f"expected {THROUGHPUT_BYTES}")
        t1 = time.perf_counter()
        stat_p = start("stat", comp)  # beside the decompress: both only read
        _, err = _cli_done(start("decompress", comp, back), "decompress")
        decompress_s = time.perf_counter() - t1
        _, dec = _cli_launches(err, "decompress")
        check(back.read_bytes() == data.tobytes(), "cli: round trip")
        stat, _ = _cli_done(stat_p, "stat")
        check("blocks=8 " in stat and "'fse_pl': 8" in stat,
              f"cli: stat says {stat!r}")
        _, werr = _cli_done(warm, "warmup")
        wenc, wdec = _cli_launches(werr, "warmup")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(min(enc, dec, wenc, wdec) > 0, "cli: a kernel never launched")
    return {"file_bytes": size, "stat": stat.strip().splitlines(),
            "compress_process_s": compress_s,
            "decompress_process_s": decompress_s,
            "launches": {"compress": enc, "decompress": dec,
                         "warmup": [wenc, wdec]},
            "seconds": time.perf_counter() - t0}


GPT2 = dict(n_layer=12, n_embd=768, vocab=50257, n_positions=1024)
GPT2_PARAMS = 124_439_808


def gpt2_state_dict(seed: int, device="cuda"):
    """A ``state_dict`` of GPT-2 small's published shapes (Radford et al.
    2019; the public ``gpt2`` config) in bf16 on ``cuda:0``, with the
    published init drawn from a seeded ``torch.Generator``: weights
    N(0, 0.02) (the residual projections ``c_proj`` 0.02 / sqrt(2 *
    n_layer)), biases 0, LayerNorm weights 1. Random, not real weights."""
    import math

    import torch

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, bf = GPT2["n_embd"], torch.bfloat16

    def normal(*shape, std=0.02):
        return (torch.randn(shape, generator=g, device=dev) * std).to(bf)

    def zeros(n):
        return torch.zeros(n, dtype=bf, device=dev)

    def ones(n):
        return torch.ones(n, dtype=bf, device=dev)

    proj = 0.02 / math.sqrt(2 * GPT2["n_layer"])
    sd = {"wte.weight": normal(GPT2["vocab"], d),
          "wpe.weight": normal(GPT2["n_positions"], d)}
    for i in range(GPT2["n_layer"]):
        h = f"h.{i}."
        sd.update({
            h + "ln_1.weight": ones(d), h + "ln_1.bias": zeros(d),
            h + "attn.c_attn.weight": normal(d, 3 * d),
            h + "attn.c_attn.bias": zeros(3 * d),
            h + "attn.c_proj.weight": normal(d, d, std=proj),
            h + "attn.c_proj.bias": zeros(d),
            h + "ln_2.weight": ones(d), h + "ln_2.bias": zeros(d),
            h + "mlp.c_fc.weight": normal(d, 4 * d),
            h + "mlp.c_fc.bias": zeros(4 * d),
            h + "mlp.c_proj.weight": normal(4 * d, d, std=proj),
            h + "mlp.c_proj.bias": zeros(d)})
    sd["ln_f.weight"], sd["ln_f.bias"] = ones(d), zeros(d)
    return sd


def _leaf_bytes(t):
    """A leaf's bytes as a host uint8 array (tensor or numpy)."""
    import numpy as np
    import torch

    if isinstance(t, torch.Tensor):
        return t.detach().contiguous().reshape(-1).view(
            torch.uint8).cpu().numpy()
    return np.ascontiguousarray(t).reshape(-1).view(np.uint8)


def _flat_leaves(tree, path=()):
    """(path, leaf) pairs of a tree in any order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat_leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat_leaves(v, path + (str(i),))]
    return [("/".join(path), tree)]


def trees_bit_equal(a, b) -> bool:
    fa, fb = dict(_flat_leaves(a)), dict(_flat_leaves(b))
    return fa.keys() == fb.keys() and all(
        tuple(fa[k].shape) == tuple(fb[k].shape)
        and (_leaf_bytes(fa[k]) == _leaf_bytes(fb[k])).all() for k in fa)


def entry_checkpoint(T, PL, tmp):
    """GPT-2 small's shapes in bf16 through ``save_pytree`` /
    ``load_pytree`` and ``Checkpoint.load_leaf``, and the ``ckpt_small``
    golden written and read without ``ml_dtypes``."""
    import struct

    import numpy as np
    import torch

    from entropy_coders_tpu_torch import checkpoint as CK
    from entropy_coders_tpu_torch import frame as TF
    from entropy_coders_tpu_torch.tools.bench_data import ckpt_tree

    sd = gpt2_state_dict(BENCH_SEED)
    n_params = sum(t.numel() for t in sd.values())
    check(n_params == GPT2_PARAMS, f"GPT-2 small has {n_params} parameters")
    path = tmp / "gpt2.fsck"
    e0, d0 = _launch_counts(PL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    size = CK.save_pytree(path, sd, checksum=True)
    save_s = time.perf_counter() - t0
    e1, d1 = _launch_counts(PL)
    t0 = time.perf_counter()
    back = CK.load_pytree(path)
    load_s = time.perf_counter() - t0
    e2, d2 = _launch_counts(PL)
    check(e1 > e0 and d2 > d1, f"checkpoint: a kernel never launched "
          f"(encode {e1 - e0}, decode {d2 - d1})")
    check(trees_bit_equal(back, sd), "checkpoint: a leaf differs")
    check(all(t.dtype == torch.bfloat16 and t.device.type == "cpu"
              for t in back.values()), "checkpoint: leaves not bf16 on CPU")

    leaf = "h.5.mlp.c_fc.weight"
    with CK.Checkpoint(path) as ck:
        m = ck.leaf_meta(leaf)
        pf = ck._pf
        b_lo = m["offset"] // pf.block_size
        b_hi = (m["offset"] + m["nbytes"] - 1) // pf.block_size + 1
        want_blocks = int((pf.modes[b_lo:b_hi] == TF.MODE_FSE_PL).sum())
        blocks0, launches0 = PL.DECODE_BLOCKS, PL.DECODE_LAUNCHES
        got = ck.load_leaf(leaf)
        leaf_blocks = PL.DECODE_BLOCKS - blocks0
        leaf_launches = PL.DECODE_LAUNCHES - launches0
        n_blocks = pf.n_blocks
        del pf
    check(trees_bit_equal({leaf: got}, {leaf: sd[leaf]}),
          f"checkpoint: load_leaf({leaf}) differs")
    check(leaf_blocks == want_blocks > 0 and leaf_launches > 0,
          f"checkpoint: load_leaf decoded {leaf_blocks} blocks, its range "
          f"holds {want_blocks} MODE_FSE_PL blocks")

    raw = path.read_bytes()
    (mlen,) = struct.unpack_from("<I", raw, 8)
    metas = json.loads(raw[12: 12 + mlen])["leaves"]
    payload = np.zeros(metas[-1]["offset"] + metas[-1]["nbytes"], np.uint8)
    for mt in metas:
        payload[mt["offset"]: mt["offset"] + mt["nbytes"]] = \
            _leaf_bytes(sd[mt["path"]])
    check(raw[12 + mlen:] == T.compress(payload, device="cuda",
                                        checksum=True),
          "checkpoint: embedded frame != compress of the payload")

    golden = json.loads((ROOT / "tests" / "data" / "golden"
                         / "manifest.json").read_text())
    case = next(c for c in golden if c["name"] == "ckpt_small")
    small = ckpt_tree(case["input"]["seed"])
    p = tmp / "small.fsck"
    CK.save_pytree(p, small, device="cuda", **{
        kk: case[kk] for kk in ("block_size", "k", "lanes", "checksum")})
    check(_sha(p.read_bytes()) == case["sha256"],
          "checkpoint: ckpt_small sha256 differs")
    check(trees_bit_equal(CK.load_pytree(ROOT / "tests" / "data" / "golden"
                                         / case["file"]), small),
          "checkpoint: the ckpt_small golden loads to another tree")
    return {"params": n_params, "raw_bytes": int(payload.size),
            "file_bytes": size, "ratio": size / payload.size,
            "save_s": save_s, "load_s": load_s,
            "save_GBps": payload.size / save_s / 1e9,
            "load_GBps": payload.size / load_s / 1e9,
            "launches": {"encode": e1 - e0, "decode": d2 - d1},
            "load_leaf": {"leaf": leaf, "nbytes": m["nbytes"],
                          "blocks_decoded": leaf_blocks,
                          "launches": leaf_launches,
                          "blocks_in_frame": n_blocks},
            "ckpt_small": "reproduced"}


def one_chunk_at_a_time(PL):
    """Patch ``PL.encode_lanes_norm``/``decode_lanes_norm`` and
    ``device_repack.encode_lanes_merged`` so that a lazy call drains its
    chunk before it returns (the loop before the pipeline: dispatch, drain,
    next chunk). Returns the undo."""
    from entropy_coders_tpu_torch.ops import device_repack as DR

    real = PL.encode_lanes_norm, PL.decode_lanes_norm
    real_merged = DR.encode_lanes_merged

    def eager(fn):
        def call(*args, lazy=False, **kw):
            out = fn(*args, lazy=lazy, **kw)
            if not lazy:
                return out
            res = out()
            return lambda: res
        return call

    PL.encode_lanes_norm, PL.decode_lanes_norm = map(eager, real)

    def merged(*args, **kw):
        res = real_merged(*args, **kw)()
        return lambda: res

    DR.encode_lanes_merged = merged

    def undo():
        PL.encode_lanes_norm, PL.decode_lanes_norm = real
        DR.encode_lanes_merged = real_merged
    return undo


def entry_pipeline(T, PL, data, knobs, frame_bytes, rounds):
    """``data`` at ``knobs`` with the chunk pipeline and with one chunk at a
    time, in turns (sync, pipe, pipe, sync; ``rounds`` times): host-clock
    wall times, each run ending synchronised; every frame ``frame_bytes``
    long and exact."""
    import torch

    sync, pipe = "one_chunk_at_a_time", "pipelined"
    times = {m: {"compress_s": [], "decompress_s": []} for m in (sync, pipe)}
    order = [sync, pipe, pipe, sync] * rounds
    for mode in order:
        undo = one_chunk_at_a_time(PL) if mode == sync else None
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = T.compress(data, device="cuda", **knobs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = T.decompress(frame, device="cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            if undo:
                undo()
        check(len(frame) == frame_bytes, f"pipeline ({mode}): frame is "
              f"{len(frame)} bytes, expected {frame_bytes}")
        check(out == data.tobytes(), f"pipeline ({mode}): round trip")
        times[mode]["compress_s"].append(t1 - t0)
        times[mode]["decompress_s"].append(t2 - t1)
    for mode in times:
        for k in ("compress_s", "decompress_s"):
            times[mode][k.replace("_s", "_median_s")] = statistics.median(
                times[mode][k])
    return {"input_bytes": len(data), "frame_bytes": frame_bytes,
            "order": order, **times}


def phase_entry_points(T, PL, gg, data):
    """Phase ``entry_points``: every count starts at 0 here; each leg
    checks its own kernels launched, and the phase that both did. The
    pipeline runs at the throughput point (2 chunks a group) and on the
    stream leg's 512 MiB at the defaults (8 chunks a group)."""
    import tempfile

    PL.DECODE_LAUNCHES = 0
    PL.ENCODE_LAUNCHES = 0
    t0 = time.perf_counter()
    big = gg.gen_sequence(0.2, 512 * MIB, BENCH_SEED + 2)
    with tempfile.TemporaryDirectory(prefix="ect_smoke_") as td:
        tmp = Path(td)
        stream, big_frame_bytes = entry_stream(T, PL, big, tmp)
        legs = {"stream": stream, "cli": entry_cli(data, tmp),
                "checkpoint": entry_checkpoint(T, PL, tmp)}
    T.compress(data, device="cuda", **THROUGHPUT)  # warm
    legs["pipeline"] = {
        "throughput": entry_pipeline(T, PL, data, THROUGHPUT,
                                     THROUGHPUT_BYTES, 2),
        "default_512MiB": entry_pipeline(T, PL, big, {}, big_frame_bytes, 1)}
    launches = {"decode": PL.DECODE_LAUNCHES, "encode": PL.ENCODE_LAUNCHES}
    check(launches["decode"] > 0 and launches["encode"] > 0,
          f"a kernel of the entry points never launched: {launches}")
    emit("entry_points", **legs, launches=launches,
         seconds=time.perf_counter() - t0)
    return launches


def phase_trace(T, points):
    """One compress plus decompress of each point of ``points`` (name ->
    (data, knobs, frame._DEVICE_REPACK for the run: None is the
    container's own route)) under the port's ``utils.trace``: the device time
    ``torch.profiler`` saw (kernels and copies) against the wall time, the
    five device ops that took the most, and the host's wall time in each
    stage of ``frame.compress``/``decompress`` (the ``ect.*`` ranges;
    ``ect.compress.tables`` and ``ect.decompress.tables`` lie inside the
    dispatch stages). The traces go to ``build/trace/``."""
    import torch

    from entropy_coders_tpu_torch import utils

    from torch.autograd import DeviceType

    from entropy_coders_tpu_torch import frame as TF

    out = {}
    for name, (data, knobs, repack) in points.items():
        saved, TF._DEVICE_REPACK = TF._DEVICE_REPACK, repack
        try:
            T.compress(data, device="cuda", **knobs)  # warm
            t0 = time.perf_counter()
            with utils.trace(ROOT / "build" / "trace") as prof:
                start_s = time.perf_counter() - t0  # the profiler's start-up
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                frame = T.compress(data, device="cuda", **knobs)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                back = T.decompress(frame, device="cuda")
                torch.cuda.synchronize()
                t3 = time.perf_counter()
        finally:
            TF._DEVICE_REPACK = saved
        check(back == data.tobytes(), f"trace ({name}): round trip")
        events = prof.key_averages()
        # device-side events only (a CPU op's self device time repeats its
        # kernels' and copies'), without the stage ranges' mirrors on the
        # device timeline
        ops = [(e.key, e.self_device_time_total, e.count)
               for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ect.")]
        copy = ("Memcpy", "Memset")
        kernel_us = sum(t for key, t, _ in ops if not key.startswith(copy))
        copy_us = sum(t for key, t, _ in ops if key.startswith(copy))
        top = sorted(ops, key=lambda o: -o[1])[:5]
        # the histogram's kernels: D6 once (one compress of one share) and
        # no CUDA bincount (kernelHistogram1D)
        hist = {key[:80]: n for key, _, n in ops if "istogram" in key}
        check(not any("Histogram1D" in key for key in hist),
              f"trace ({name}): CUDA's bincount ran: {hist}")
        check(name != "throughput"
              or sum(n for key, n in hist.items()
                     if "histogram_kernel" in key) == 1,
              f"trace ({name}): D6 kernels seen {hist}, expected one")
        stages = {e.key: {"host_ms": e.cpu_time_total / 1e3, "calls": e.count}
                  for e in events if e.key.startswith("ect.")
                  and e.device_type == DeviceType.CPU}
        check(any(k.startswith("ect.compress.") for k in stages)
              and any(k.startswith("ect.decompress.") for k in stages),
              f"trace ({name}): no stage range in the profile: {stages}")
        wall_s = t3 - t1
        # busy share: device op time over the wall time of the work (copies
        # on the side streams may overlap kernels and count twice)
        out[name] = dict(
            wall_ms=wall_s * 1e3, compress_ms=(t2 - t1) * 1e3,
            decompress_ms=(t3 - t2) * 1e3, profiler_start_s=start_s,
            device_kernel_ms=kernel_us / 1e3, device_copy_ms=copy_us / 1e3,
            device_busy_share=(kernel_us + copy_us) / 1e3 / (wall_s * 1e3),
            device_time_visible=bool(ops), histogram_ops=hist,
            top5=[{"op": key[:120], "ms": t / 1e3, "calls": n}
                  for key, t, n in top],
            host_stages=dict(sorted(stages.items())))
    emit("trace", **out)


# config 6's ratios of the corpora that do not read the tree's text
# (BASELINE.md:75-79): (throughput point, parity point), to 4 places. The
# wire bytes are fixed, so the card gives the ratios the JAX package gave.
CONFIG6_RATIOS = {"geo(bench)": (0.4599, 0.4528), "bf16": (0.8310, 0.8337),
                  "jsonlog": (0.6166, 0.6122)}
CONFIG_TIMER_CALLS = 15  # configs 3, 4, 6 (x5) and 2 x 4 sweep rate points


def turn_points(BC, PS, corpora) -> dict:
    """name -> (frame, data, knobs) of the frames whose B1 rates phase
    ``configs`` retakes in turns: each config-6 corpus at the throughput
    point (``table_log=8``: a block whose symbols reach 255 takes L = 9,
    the reference's table-length clamp), and geo at each of the sweep's
    logs in both sweep configs (geo's ``bench`` L = 8 frame is the
    throughput frame again: two entries of one frame show the spread)."""
    from entropy_coders_tpu_torch import compress

    points = {}
    for name, key in BC.CONFIG6_CORPORA.items():
        data = corpora.get(key, BC.CORPUS_BYTES)
        points[f"{name} throughput"] = (compress(
            data, **BC.THROUGHPUT, lanes=True, device="cuda"), data,
            BC.THROUGHPUT)
    geo = corpora.get("geo", PS.SIZE)
    for cname, cfg in PS.CONFIGS.items():
        for L in PS.LS:
            points[f"geo {cname} L{L}"] = (compress(
                geo, table_log=L, lanes=True, device="cuda", **cfg), geo, cfg)
    return points


def rates_in_turns(points, passes: int = 2) -> dict:
    """B1's rate on each frame of ``points``, the frames timed in turns
    (``bench_configs.device_decode_gbps``), forward then backward, so that
    no frame gains from its place in the order: per frame its L, the
    median GB/s over every run of every pass, and their range."""
    from entropy_coders_tpu_torch.tools import bench_configs as BC

    order = list(points)
    runs = {name: [] for name in order}
    enqueue = {name: [] for name in order}
    logs = {}
    for i in range(passes):
        for name in (order if i % 2 == 0 else order[::-1]):
            frame, data, knobs = points[name]
            rate = BC.device_decode_gbps(frame, knobs["block_size"],
                                         knobs["k"], data=data)
            raw = rate.blocks * knobs["block_size"]
            runs[name] += [raw / ms / 1e6 for ms in rate.runs_ms]
            enqueue[name].append(rate.enqueue_ms)
            logs[name] = rate.L
    return {name: {"L": logs[name], "GBps": statistics.median(r),
                   "GBps_range": [min(r), max(r)], "runs": len(r),
                   "enqueue_ms": statistics.median(enqueue[name])}
            for name, r in runs.items()}


def phase_configs(PL):
    """The root scripts' measurements on the card (``tools.bench_configs``,
    ``tools.policy_sweep``), at the JAX sizes: configs 1-6, then the
    table-log policy sweep, sharing one build of each corpus. Each result
    line is printed as it comes, then each corpus's sha256 (the text
    corpora follow the tree's root files). Checks: every round trip exact
    (the tools raise otherwise); geo, bf16 and jsonlog give config 6's
    ratios (``CONFIG6_RATIOS``); every decode-rate timer call's B1
    launches, as the wrapper counts them, are the calls the timer counted.
    Then B1's rate at the throughput point on each corpus (config 6)
    beside the sweep's per-L rates on geo, and the same frames' rates
    retaken in turns with the range of their runs (``rates_in_turns``):
    whether B1's rate depends on the corpus."""
    from entropy_coders_tpu_torch.tools import bench_configs as BC
    from entropy_coders_tpu_torch.tools import policy_sweep as PS

    real = BC.device_decode_gbps
    timer_calls = []

    def counted_timer(*args, **kwargs):
        before = PL.DECODE_LAUNCHES
        rate = real(*args, **kwargs)
        made = PL.DECODE_LAUNCHES - before
        check(made == rate.launches > 0,
              f"the decode-rate timer counted {rate.launches} B1 calls; "
              f"the wrapper launched {made}")
        timer_calls.append(made)
        return rate

    def out(line):
        emit("configs", **json.loads(line))

    corpora = BC.Corpora()
    BC.device_decode_gbps = counted_timer
    try:
        t0 = time.perf_counter()
        results = {r["config"]: r
                   for r in BC.run(device="cuda", corpora=corpora, out=out)}
        t1 = time.perf_counter()
        sweep = PS.sweep(device="cuda", corpora=corpora, out=out)
        t2 = time.perf_counter()
        check(len(timer_calls) == CONFIG_TIMER_CALLS,
              f"{len(timer_calls)} decode-rate timer calls, expected "
              f"{CONFIG_TIMER_CALLS}")
        points = turn_points(BC, PS, corpora)
        turns = rates_in_turns(points)
        # the same without the spin before each run: the events then time
        # the host's launches wherever they are slower than B1
        hold, BC.HOLD_CYCLES = BC.HOLD_CYCLES, 0
        try:
            turns_unheld = rates_in_turns(points)
        finally:
            BC.HOLD_CYCLES = hold
    finally:
        BC.device_decode_gbps = real
    rows = results[6]["corpora"]
    for name, (thr, par) in CONFIG6_RATIOS.items():
        got = (round(rows[name]["ratio_throughput_L8"], 4),
               round(rows[name]["ratio_parity_L11_packed"], 4))
        check(got == (thr, par), f"config 6 {name}: ratios {got}, expected "
              f"{(thr, par)}")
    emit("configs_summary", configs_s=t1 - t0, sweep_s=t2 - t1,
         turns_s=time.perf_counter() - t2, rates_in_turns=turns,
         rates_in_turns_unheld=turns_unheld,
         timer_calls=len(timer_calls), timer_launches=sum(timer_calls),
         corpora_sha256={f"{name}@{n}": corpora.sha256(name, n)
                         for name, n in corpora.built()},
         config6_L8_by_corpus={name: {"GBps": r["device_decode_GBps_L8"],
                                      "L": r["decode_L"]}
                               for name, r in rows.items()},
         sweep_rates_geo={c: {str(L): g for L, g in r.items()}
                          for c, r in sweep["rates"].items()})


def phase_bench(T, gg, card):
    """The port's bench (``tools.bench``), the root ``bench.py``'s
    counterpart, as a subprocess, so that its cold start is a fresh
    process's (the libraries are built by now: ``cold_start_s`` shows a
    load): its two lines parsed and checked (``"backend": "cuda"``, the
    frames of 61,729,231 and 60,779,273 bytes, the parity ratio at or
    under 0.4530) and printed beside the card. Then
    ``tests/tpu_smoke.py``'s big-block check: (512 KiB + 321) bytes at
    k=8192, per-lane, compressed on the card equal to the same compress on
    the CPU's plain versions byte for byte, and round-tripped."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m",
                        "entropy_coders_tpu_torch.tools.bench"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    bench_s = time.perf_counter() - t0
    check(p.returncode == 0, f"the bench exited {p.returncode}:\n"
          f"{p.stderr[-4000:]}")
    line1 = json.loads(p.stdout.strip().splitlines()[-1])
    line2 = [json.loads(ln) for ln in p.stderr.splitlines()
             if ln.startswith("{")][-1]
    check(line2["backend"] == "cuda", f"bench backend {line2['backend']}")
    check(line2["compressed_bytes"] == THROUGHPUT_BYTES,
          f"bench throughput frame {line2['compressed_bytes']} bytes")
    check(line2["parity"]["compressed_bytes"] == PARITY_BYTES,
          f"bench parity frame {line2['parity']['compressed_bytes']} bytes")
    check(line1["parity_ratio"] <= REFERENCE_RATIO,
          f"bench parity ratio {line1['parity_ratio']}")
    t0 = time.perf_counter()
    data = gg.gen_sequence(0.2, (512 << 10) + 321, 77)
    kw = dict(block_size=512 << 10, k=8192, lanes=True)
    real = T.compress(data, device="cuda", **kw)
    check(real == T.compress(data, device="cpu", **kw),
          "big-block: the card's frame differs from the plain versions'")
    check(T.decompress(real, device="cuda") == data.tobytes(),
          "big-block: the card's round trip")
    emit("bench", card=card, bench_s=bench_s, line1=line1, line2=line2,
         big_block={"input_bytes": len(data), "frame_bytes": len(real),
                    "equal_to_plain": True,
                    "seconds": time.perf_counter() - t0})


def dryrun_plain(G, n):
    """``dryrun_multichip(n)``'s frames as the plain versions write them on
    the CPU, unsharded. On a CUDA mesh ``lanes`` unset means per-lane (the
    JAX package's TPU default), which sets the table log of the frames that
    leave it unset, so the CPU is given ``lanes=True`` too."""
    from entropy_coders_tpu_torch import compress

    data = G.dryrun_data(n)
    return {name: compress(data, block_size=G.DRYRUN_BLOCK, device="cpu",
                           **{"lanes": True, **kw})
            for name, kw in G.DRYRUN_FRAMES}


def phase_graft():
    """The root ``__graft_entry__.py``'s counterpart (``tools.graft_entry``)
    on the card: ``entry("cuda")``'s four outputs equal ``entry("cpu")``'s,
    the block round-trips exactly through the same cores
    (``block_roundtrip``), and ``dryrun_multichip`` passes over every card
    and over four virtual ranks of card 0, its four frames equal byte for
    byte to the plain versions' (``dryrun_plain``)."""
    import torch

    from entropy_coders_tpu_torch.tools import graft_entry as G

    t0 = time.perf_counter()
    fn, args = G.entry("cuda")
    got = fn(*args)
    cfn, cargs = G.entry("cpu")
    want = cfn(*cargs)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "entry: the card's outputs differ from the plain run's")
    data = G.example_block(device="cpu")[1]["data"]
    check(G.block_roundtrip("cuda") == data.tobytes(),
          "entry: the block's round trip")
    n = torch.cuda.device_count()
    cards = G.dryrun_multichip(n)
    check(cards == dryrun_plain(G, n),
          "dryrun: the cards' frames differ from the plain versions'")
    virtual = G.dryrun_multichip(4, mesh=(torch.device("cuda", 0),) * 4)
    check(virtual == dryrun_plain(G, 4),
          "dryrun: the virtual ranks' frames differ from the plain versions'")
    emit("graft", entry_shapes=[list(g.shape) for g in got],
         dryrun_cards=n, dryrun_frames={k: len(v) for k, v in cards.items()},
         virtual_ranks=4,
         virtual_frames={k: len(v) for k, v in virtual.items()},
         seconds=time.perf_counter() - t0)


_SASS_LAT = {}


def sass_and_latencies():
    """The kernels' SASS and the card's instruction latencies, which B1's
    and B2's bounds are counted from (``tools.lane_shapes``); taken once a
    run."""
    from entropy_coders_tpu_torch.kernels import build as KB
    from entropy_coders_tpu_torch.tools import lane_shapes as LS

    if not _SASS_LAT:
        _SASS_LAT["text"] = LS.sass(KB.build())
        _SASS_LAT["lat"] = LS.latencies()
        emit("latencies", cycles=_SASS_LAT["lat"],
             sass=LS.latency_sass(_SASS_LAT["text"]))
    return _SASS_LAT["text"], _SASS_LAT["lat"]


def phase_timing(data):
    """Kernel times on device-resident tensors: one 16 MiB block and all
    eight at the throughput and parity points, then one launch at each of
    the main path's launch shapes (``tools.lane_shapes``: B=4 at the
    throughput and parity points, 512 blocks of 128 KiB at k=1024 and the
    default policy's table log). At a launch shape the kernels and the
    plain versions run on the same tensors and their outputs must agree;
    each time is printed beside its bound and the share of the bound, and
    at the throughput shape the plain versions are timed too. D1-D3 run on
    the same tensors (``tools.device_host``): split of merge is the
    identity on B2's output, and their times stand beside their bounds,
    their plain versions and the C++ calls in turns."""
    import torch

    from entropy_coders_tpu_torch.ops import pl_coder as PL
    from entropy_coders_tpu_torch.tools import device_host as DH
    from entropy_coders_tpu_torch.tools import lane_shapes as LS
    from entropy_coders_tpu_torch.tools.bench_data import cuda_ms

    blocks = data.reshape(-1, BLOCK)
    out = {}
    for name, L, k in (("throughput", 8, 16384), ("parity", 11, 8192)):
        one = compare_lanes(blocks[:1], L, k, time_kernels=True)
        full = compare_lanes(blocks, L, k, time_kernels=True)
        out[name] = {"one_block": one, "all_blocks": full}
        emit(f"timing_{name}", one_block=one, all_blocks=full)

    text, lat = sass_and_latencies()
    clocks = LS.card_clocks()
    old_repack, old_kernels = parent_kernels()
    if old_kernels is not None:
        out["b1_sass_diff"] = LS.b1_sass_diff(LS.sass(old_kernels.path), text)
        emit("b1_sass", parent=out["b1_sass_diff"])
    shapes = {}
    for name in LS.SHAPES:
        inp = LS.shape_inputs(name, data)
        B, k, L, R, W = inp.B, inp.k, inp.L, inp.R, inp.W
        plain = {
            "encode": lambda: PL.encode_call_ref(inp.blocks, inp.tabs, k=k,
                                                 L=L, W=W),
            "decode": lambda: PL.decode_call_ref(inp.words, inp.sizes,
                                                 inp.tabs.dec, L=L, R=R)}
        got = {kind: LS.run_new(kind, inp) for kind in plain}
        want = {kind: fn() for kind, fn in plain.items()}
        torch.cuda.synchronize()
        err = max(max_abs_diff(a, b) for kind in plain
                  for a, b in zip(got[kind], want[kind]))
        check(err == 0, f"{name} launch: kernel != plain version: {err}")
        syms, finals, cur = got["decode"]
        check(not bool(cur.any()), f"{name} launch: cursors not drained")
        check(torch.equal(torch.cat([syms.reshape(B, -1), finals], 1),
                          inp.blocks), f"{name} launch: round trip")
        row = {"B": B, "k": k, "L": L, "R": R, "W": W, "max_abs_err": err,
               "threads": {kind: PL.lane_config(kind, k, L)[0]
                           for kind in plain}}
        for kind in plain:
            ms, runs = cuda_ms(lambda: LS.run_new(kind, inp), reps=LS.REPS)
            st = LS.kernel_stats(kind, k, L, text, lat)
            b = LS.shape_bound(kind, inp, st, clocks["sm_max_mhz"])
            row[kind] = {"ms": ms, "ms_runs": runs, **st, **b,
                         "share_of_bound": b["bound_ms"] / ms}
            if name == "throughput":  # the comparison above warmed it up
                row[kind]["plain_ms"] = cuda_ms(plain[kind], runs=2,
                                                warmup=0)[0]
        if old_kernels is not None:  # B1 in turns with the parent's
            row["decode"].update(kernels_in_turns(
                lambda lib: DH.decode_with(lib, inp.words, inp.sizes,
                                           inp.tabs.dec, L, R),
                f"{name} launch B1"))
        row["clocks"] = {"before": clocks, "after": LS.card_clocks()}
        # D1 and D2 on this shape's tensors: the wire form the point uses
        row["device_host"] = {
            "repack": DH.shape_repack(inp, pack_bits=name == "parity",
                                      old=old_repack)}
        shapes[name] = row
        emit(f"timing_shape_{name}", **row)
        del inp, got, want
    out["shapes"] = shapes
    # D3 at one chunk's and one lane group's launch shapes, and at L = 15
    out["tables"] = DH.tables_shapes(data, old_kernels)
    for name, row in out["tables"].items():
        emit(f"timing_tables_{name}", **row)
    # D6 at its launch shapes beside the bincount route, and the byte
    # patterns side by side
    out["histogram"] = DH.histogram_shapes(data)
    emit("timing_histogram", **out["histogram"])
    # the crc kernel at its launch shapes beside its plain version and
    # zlib.crc32 on the host
    out["crc"] = DH.crc_shapes(data)
    emit("timing_crc", **out["crc"])
    return out


def kernels_in_turns(call, what: str, rounds: int = 2) -> dict:
    """``call(lib)`` of the parent's library and of this commit's, in turns
    (``device_host.old_in_turns``: old, new, new, old), the same host work
    around either; their outputs must be equal."""
    import torch

    from entropy_coders_tpu_torch.tools import device_host as DH

    old, new = parent_kernels()[1], DH.current_kernels()
    check(all(torch.equal(a, b) for a, b in zip(call(old), call(new))),
          f"{what}: the parent's kernel differs")
    return DH.old_in_turns(lambda: call(old), lambda: call(new), rounds)


_PARENT = {}


def parent_kernels():
    """(the parent's repack library, its D3/B1/layout library) when
    ``build/parent`` holds a checkout of a parent commit, else (None,
    None); built once a run."""
    from entropy_coders_tpu_torch.tools import device_host as DH

    parent = ROOT / "build" / "parent"
    if "libs" not in _PARENT:
        csrc = parent / "entropy_coders_tpu_torch" / "csrc"
        _PARENT["libs"] = ((DH.load_old(parent), DH.load_parent(parent))
                           if (csrc / "tables.cu").exists() else (None, None))
    return _PARENT["libs"]


# --- the decode table-layout tools (B4/B5) ------------------------------------


def layout_vs_plain(inp, full=False):
    """Each layout that applies to ``inp`` (``l10_attack.LaneInputs``) on
    its first block: the layout kernel against its plain version on the
    same tensors, syms, finals and cursors exactly. With ``full``, also
    the kernel's and the plain version's times on that block, and one
    lane's size corrupted (``^= 0x4000``, past anything R rounds consume)
    in the block's first 128 lanes: kernel and plain version agree and the
    lane's cursor does not drain. Returns (largest difference, {layout:
    {"ms": kernel, "plain_ms": plain version}} when ``full``)."""
    import torch

    from entropy_coders_tpu_torch.tools import l10_attack_harness as H
    from entropy_coders_tpu_torch.tools.bench_data import cuda_ms

    L, R = inp.L, inp.R
    w, s, dec = inp.words[:1], inp.sizes[:1], inp.dec[:1]
    cases = [(w, s, False)]
    if full:
        cw = inp.words.view(torch.int32)[:1, :, :128].contiguous()
        cs = inp.sizes[:1, :128].clone()
        cs[0, 3] ^= 0x4000
        cases.append((cw.view(torch.uint32), cs, True))
    worst, times = 0, {}
    for name in H.LAYOUTS:
        if not H.layout_applies(name, inp.norm_tables, L):
            continue
        table = H.layout_tables(dec, L, name)
        for words, sizes, bad in cases:
            got = H.decode_lanes_layout(words, sizes, table, layout=name,
                                        L=L, R=R)
            ref = H.decode_lanes_layout_ref(words, sizes, table, layout=name,
                                            L=L, R=R)
            torch.cuda.synchronize()
            err = max(max_abs_diff(a, b) for a, b in zip(got, ref))
            check(err == 0, f"L={L} {name}: kernel != plain version "
                  f"({'corrupt' if bad else 'one block'}): {err}")
            worst = max(worst, err)
            if bad:
                check(int(got[2][0, 3]) != 0,
                      f"L={L} {name}: the corrupted lane drained")
            else:
                check(not bool(got[2].any()), f"L={L} {name}: cursors")
        if full:  # the plain version's comparison above was its warm-up
            times[name] = {
                "ms": cuda_ms(lambda t=table, n=name: H.decode_lanes_layout(
                    w, s, t, layout=n, L=L, R=R))[0],
                "plain_ms": cuda_ms(
                    lambda t=table, n=name: H.decode_lanes_layout_ref(
                        w, s, t, layout=n, L=L, R=R), runs=2, warmup=0)[0]}
    return worst, times


def phase_layouts(data):
    """B4/B5 through the layout tools: ``l10_attack.run`` at L=10 on the
    128 MiB bench data and ``upack_hilog.run`` at L=11 and 13 on its
    64 MiB 40-symbol corpus and at L=13 on 128 MiB of it (their path: the
    counts start at 0 just before and are read just after), then every
    instantiation against its plain version (``layout_vs_plain``) and the
    flat table's co-resident CTAs per SM at L = 10..15, and the flat
    instantiation's SASS against B1's. Returns (launches per layout,
    largest difference, the L=10 results, the one-block times at L=10,
    the eight blocks in turns with the parent's kernel or None)."""
    import torch

    from entropy_coders_tpu_torch.tools import l10_attack as LA
    from entropy_coders_tpu_torch.tools import l10_attack_harness as H
    from entropy_coders_tpu_torch.tools import lane_shapes as LS
    from entropy_coders_tpu_torch.tools import upack_hilog as UH

    t0 = time.perf_counter()
    for name in H.LAYOUT_LAUNCHES:
        H.LAYOUT_LAUNCHES[name] = 0
    points = {"L10_bench": LA.run(10, BENCH_SIZE)}
    for L in (11, 13):
        points[f"L{L}_hilog"] = UH.run(L)
    # 8 blocks at L=13: 1,024 CTAs, more than one wave of flat's CTAs per
    # SM can hold, and not of upack's
    points["L13_hilog_128MiB"] = UH.run(13, BENCH_SIZE)
    launches = dict(H.LAYOUT_LAUNCHES)
    check(all(n > 0 for n in launches.values()),
          f"a layout of the tools' path never launched: {launches}")
    # upack_hilog.run raises where upack does not apply; l10_attack.run
    # skips such a layout, and at L=10 on this data all five apply
    check(all(r["eligible"] for r in points["L10_bench"].values()),
          f"L=10: a layout did not apply: {points['L10_bench']}")

    inp10 = LA.lane_inputs(data, 10)
    worst, one10 = layout_vs_plain(inp10, full=True)
    turns = layouts_in_turns(inp10)
    # the work of one block's decode at L=10 and of all eight, whatever the
    # table's layout, as B1's instructions count it
    k10 = inp10.sizes.shape[1]
    for rows, B in ((one10, 1), (turns or {}, inp10.sizes.shape[0])):
        b = LS.bound(
            "decode", B=B, k=k10, L=10, R=inp10.R,
            W=inp10.words.shape[1], sizes=inp10.sizes[:B],
            stats=LS.kernel_stats("decode", k10, 10, *sass_and_latencies()),
            sm_max_mhz=LS.card_clocks()["sm_max_mhz"],
            n_sm=torch.cuda.get_device_properties(0).multi_processor_count)
        for row in rows.values():
            row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    del inp10
    for L in (11, 13):
        err, _ = layout_vs_plain(LA.lane_inputs(UH.corpus(64 * MIB), L))
        worst = max(worst, err)
    flat_ctas = {L: H.layout_occupancy("flat", L) for L in range(10, 16)}
    # the layout kernel's flat instantiation against B1, in this build
    text = sass_and_latencies()[0]
    flat_sass = LS.sass_diff(text, LS.B1_SASS, text, LS.FLAT_LAYOUT_SASS)
    emit("layouts", points=points, one_block_L10=one10, in_turns=turns,
         flat_ctas_per_sm=flat_ctas, flat_sass_vs_b1=flat_sass,
         launches=launches, max_abs_err=worst,
         seconds=time.perf_counter() - t0)
    return launches, worst, points["L10_bench"], one10, turns


def layouts_in_turns(inp, rounds: int = 2):
    """With ``build/parent``: B1 and each layout that applies on all of
    ``inp``'s blocks (eight of 16 MiB at L=10), the parent's kernel and
    this commit's called the same way in turns (``kernels_in_turns``),
    outputs equal. Else None."""
    from entropy_coders_tpu_torch.tools import device_host as DH
    from entropy_coders_tpu_torch.tools import l10_attack_harness as H

    if parent_kernels()[1] is None:
        return None
    L, R, w, s = inp.L, inp.R, inp.words, inp.sizes
    out = {"B1": kernels_in_turns(
        lambda lib: DH.decode_with(lib, w, s, inp.dec, L, R), "L=10 B1",
        rounds)}
    for name in H.LAYOUTS:
        if H.layout_applies(name, inp.norm_tables, L):
            t = H.layout_tables(inp.dec, L, name)
            out[name] = kernels_in_turns(
                lambda lib, t=t, n=name: DH.layout_with(lib, w, s, t, n, L, R),
                f"L=10 {name}", rounds)
    return out


# --- the JAX package's lane entries ------------------------------------------


def entry_inputs(name: str, data):
    """Host numpy inputs of the ``name`` launch shape (``tools.lane_shapes``)
    as a caller of the JAX package's entries passes them: (B, R, k) symbols,
    (B, k) last bytes, B ``(table, tt_bits, tt_fs)`` tuples and B packed
    decode rows from the port's host library."""
    import numpy as np

    from entropy_coders_tpu_torch import native
    from entropy_coders_tpu_torch.normalize import normalize_batch
    from entropy_coders_tpu_torch.ops import pl_coder as PL
    from entropy_coders_tpu_torch.tools import lane_shapes as LS

    s = LS.SHAPES[name]
    B, block, k = s["B"], s["block"], s["k"]
    L = s["L"] if s["L"] is not None else LS.default_log(data, block)
    blocks = np.resize(data, B * block).reshape(B, block)
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks])
    nt, logs = normalize_batch(counts, block, L)
    check((logs == L).all(), f"{name}: table log raised above {L}")
    table, tt_bits, tt_fs = native.build_encode_tables(nt, L)
    R = block // k - 1
    return dict(name=name, B=B, k=k, L=L, R=R, W=PL.encode_w_bound(R, L),
                blocks=blocks, syms=blocks[:, : R * k].reshape(B, R, k),
                init=blocks[:, R * k:],
                enc_tables=[(table[b], tt_bits[b], tt_fs[b])
                            for b in range(B)],
                stacked=(table, tt_bits, tt_fs),
                packs=list(native.build_decode_tables(nt, L)))


def counted(PL, fn, encode: int, decode: int, what: str):
    """``fn()``, checking that it launched exactly ``encode`` B2 and
    ``decode`` B1 kernels."""
    before = (PL.ENCODE_LAUNCHES, PL.DECODE_LAUNCHES)
    out = fn()
    moved = (PL.ENCODE_LAUNCHES - before[0], PL.DECODE_LAUNCHES - before[1])
    check(moved == (encode, decode),
          f"{what}: launched (B2, B1) = {moved}, expected {(encode, decode)}")
    return out


def phase_lane_entries(data, card: str):
    """The JAX package's entries ``ops.encode_lanes`` / ``decode_lanes`` on
    the card at the main path's three launch shapes, host numpy in: the
    encode equals its plain version on the CPU on one block (``w_act``
    included) and ``encode_call`` on the same blocks and tables (trimmed
    the same way), the decode gives the input back, a corrupted lane size
    raises ValueError, and each call launches one B2 or B1. Each entry's
    host time and CUDA-event time stand beside those of the
    ``encode_call`` / ``decode_call`` it wraps on device-resident inputs;
    the difference is the entry's own work (the numpy inputs' staging in
    pinned memory and h2d, the table stacking, the block concat, the
    trim's sync). Returns the rows and the largest difference seen."""
    import numpy as np
    import torch

    from entropy_coders_tpu_torch.ops import pl_coder as PL
    from entropy_coders_tpu_torch.ops.unsigned import to_device, to_numpy
    from entropy_coders_tpu_torch.tools.bench_data import cuda_ms

    dev = torch.device("cuda", torch.cuda.current_device())
    rows, worst = {}, 0
    for name in ("throughput", "parity", "default"):
        c = entry_inputs(name, data)
        B, k, L, R, W = c["B"], c["k"], c["L"], c["R"], c["W"]

        def enc(**kw):
            return PL.encode_lanes(c["syms"], c["init"], c["enc_tables"],
                                   k=k, L=L, W=W, **kw)

        words, sizes = counted(PL, enc, 1, 0, f"{name} encode_lanes")
        check(words.device == dev and sizes.device == dev,
              f"{name}: encode_lanes ran on {words.device}")
        w_act = min((int(sizes.max()) + 31) // 32 + 1, W)
        blocks = torch.from_numpy(c["blocks"]).to(dev)
        tabs = PL.LaneTables(None, *(to_device(t, dev) for t in
                                     c["stacked"][1:]),
                             to_device(c["stacked"][0], dev))
        cw, cs = counted(PL, lambda: PL.encode_call(blocks, tabs, k=k, L=L,
                                                    W=W), 1, 0,
                         f"{name} encode_call")
        err = max(max_abs_diff(words, cw[:, :w_act]), max_abs_diff(sizes, cs))
        check(words.shape[1] == w_act and err == 0,
              f"{name}: encode_lanes != encode_call trimmed: {err}")
        # one block on the card and in the plain version on the CPU
        one = counted(PL, lambda: PL.encode_lanes(
            c["syms"][:1], c["init"][:1], c["enc_tables"][:1], k=k, L=L,
            W=W), 1, 0, f"{name} encode_lanes one block")
        plain = counted(PL, lambda: PL.encode_lanes(
            c["syms"][:1], c["init"][:1], c["enc_tables"][:1], k=k, L=L,
            W=W, device="cpu"), 0, 0, f"{name} plain encode_lanes")
        check(one[0].shape == plain[0].shape,
              f"{name}: w_act {one[0].shape} != plain {plain[0].shape}")
        one_err = max(int(np.abs(to_numpy(a).astype(np.int64)
                                 - to_numpy(b).astype(np.int64)).max())
                      for a, b in zip(one, plain))
        check(one_err == 0, f"{name}: encode_lanes != plain: {one_err}")
        # decode from read-only host numpy, as ``np.asarray`` of a JAX
        # array holds the words
        words_np, sizes_np = to_numpy(words), sizes.cpu().numpy()
        words_np.setflags(write=False)

        def dec(w=words_np, s=sizes_np):
            return PL.decode_lanes(w, s, c["packs"], k=k, L=L, R=R)

        syms, finals = counted(PL, dec, 0, 1, f"{name} decode_lanes")
        got = torch.cat([syms.reshape(B, -1), finals], 1).cpu().numpy()
        check((got == c["blocks"]).all(), f"{name}: decode_lanes round trip")
        bad = sizes_np.copy()
        bad[0, 3] ^= 0x4000  # past anything R rounds can consume

        def corrupt():
            try:
                dec(s=bad)
            except ValueError:
                return True
            return False

        check(counted(PL, corrupt, 0, 1, f"{name} corrupt decode_lanes"),
              f"{name}: a corrupt lane size decoded without ValueError")
        dec_dev = to_device(np.stack(c["packs"]), dev)
        times = {}
        for kind, entry, call in (
                ("encode", enc, lambda: PL.encode_call(blocks, tabs, k=k, L=L,
                                                       W=W)),
                ("decode", dec, lambda: PL.decode_call(words, sizes, dec_dev,
                                                       L=L, R=R))):
            t = {"entry_host_ms": host_ms(entry, [dev], runs=5, warmup=1)[0],
                 "entry_ms": cuda_ms(entry, runs=5, warmup=1)[0],
                 "call_host_ms": host_ms(call, [dev], runs=5, warmup=1)[0],
                 "call_ms": cuda_ms(call, runs=5, warmup=1)[0]}
            t["entry_own_ms"] = t["entry_ms"] - t["call_ms"]
            times[kind] = t
        rows[name] = {"B": B, "k": k, "L": L, "R": R, "W": W, "w_act": w_act,
                      "input_bytes": int(c["blocks"].nbytes),
                      "words_bytes": int(words_np.nbytes),
                      "max_abs_err": max(err, one_err),
                      "launches_a_call": {"encode_lanes": [1, 0],
                                          "decode_lanes": [0, 1]},
                      "corrupt_raises": True, **times, "card": card}
        worst = max(worst, err, one_err)
        emit(f"lane_entries_{name}", **rows[name])
        del c, words, sizes, cw, cs, blocks, tabs, one, plain, syms, finals
    return rows, worst


# --- the multi-device path ----------------------------------------------------


def _bits(t):
    """Integer view of a tensor for exact comparison (4-byte types as
    int32 bit patterns, so float32 compares bit for bit)."""
    import torch

    return t.view(torch.int32) if t.element_size() == 4 else t


def ring_case(shards, mesh, accumulate=False):
    """B3 and its plain version on the same shards: every rank's output
    and accumulator must agree exactly and equal the stacked shards / their
    sum. Returns the largest difference."""
    import torch

    from entropy_coders_tpu_torch.parallel import rdma as R

    outs, accs = R._ring_call(shards, mesh, accumulate)
    routs, raccs = R._ring_call_ref(shards, mesh, accumulate)
    torch.cuda.synchronize()
    want = torch.stack([_bits(s).to(mesh[0]) for s in shards])
    err = 0
    for d in range(len(mesh)):
        err = max(err, max_abs_diff(_bits(outs[d]), _bits(routs[d])))
        check(torch.equal(_bits(outs[d]).to(mesh[0]), want),
              f"rank {d} output != the stacked shards (n={len(mesh)})")
        if accumulate:
            err = max(err, max_abs_diff(accs[d], raccs[d]))
            total = want.to(torch.int64).sum(0)
            total = (((total + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(
                torch.int32)
            check(torch.equal(_bits(accs[d]).to(mesh[0]), total),
                  f"rank {d} accumulator != the sum (n={len(mesh)})")
    check(err == 0, f"B3 != plain version (n={len(mesh)}): {err}")
    return err


def ring_cases(mesh, rank_counts):
    """The ring's cases on one mesh, each on the mesh's one cached state:
    int32 (n*2, 4, 128) gathered and summed, int32 (n*3, 5) (a 60-byte
    chunk: B3's 4-byte path) gathered and summed, float32 (n, 8, 128), and
    the histogram all-reduce of ``rank_counts`` (n, 256)."""
    import numpy as np
    import torch

    from entropy_coders_tpu_torch.parallel import rdma as R

    n = len(mesh)
    rng = np.random.default_rng(BENCH_SEED + n)
    x = torch.from_numpy(rng.integers(0, 1 << 30, (n * 2, 4, 128)).astype(
        np.int32))
    w = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (n * 3, 5)).astype(
        np.int32))
    f = torch.from_numpy(rng.standard_normal((n, 8, 128)).astype(np.float32))
    err = 0
    for t, acc in ((x, False), (x, True), (w, False), (w, True), (f, False)):
        shards = [s.to(d).contiguous() for s, d in zip(t.tensor_split(n), mesh)]
        err = max(err, ring_case(shards, mesh, acc))
    check(torch.equal(R.ring_all_gather(x, mesh).cpu(), x),
          f"ring_all_gather != x (n={n})")
    counts = torch.from_numpy(rank_counts.astype(np.int32))
    shards = [c.reshape(2, 128).to(d).contiguous()
              for c, d in zip(counts, mesh)]
    err = max(err, ring_case(shards, mesh, True))
    total = R.ring_all_reduce_histograms(rank_counts, mesh).cpu().numpy()
    check((total == rank_counts.sum(0)).all(),
          f"ring_all_reduce_histograms != the sum (n={n})")
    return err


def rank_counts(blocks_dev, n):
    """(n, 256) int64 byte counts of each rank's contiguous share of the
    device-resident blocks."""
    import numpy as np

    from entropy_coders_tpu_torch.frame import _shares
    from entropy_coders_tpu_torch.ops.histogram import histogram_blocks

    out = np.zeros((n, 256), np.int64)
    for i, (_, _, lo, hi) in enumerate(_shares(blocks_dev.shape[0],
                                               (None,) * n)):
        out[i] = histogram_blocks(blocks_dev[lo:hi]).sum(0).cpu().numpy()
    return out


def cards_ms(fn, devices, runs: int = 7, warmup: int = 2):
    """Median over runs of the slowest card's device time of ``fn``: CUDA
    events on each card's current stream before and after the call; also
    every run's. A card's time starts at its own event, so it holds the
    launches' skew and the wait for the other cards."""
    import torch

    devices = list(dict.fromkeys(devices))
    for _ in range(warmup):
        fn()
    for d in devices:
        torch.cuda.synchronize(d)
    times = []
    for _ in range(runs):
        starts, ends = [], []
        for d in devices:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(d))
            starts.append(ev)
        fn()
        for d in devices:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(d))
            ends.append(ev)
        for ev in ends:
            ev.synchronize()
        times.append(max(a.elapsed_time(b) for a, b in zip(starts, ends)))
    return statistics.median(times), times


# what no B3 call after a mesh's first may issue (runtime API names)
RING_SET_UP_CALLS = ("cudaDeviceCanAccessPeer", "cudaDeviceEnablePeerAccess",
                     "cudaOccupancyMaxActiveBlocksPerMultiprocessor",
                     "cudaMemsetAsync", "cudaMemset", "cudaEventRecord",
                     "cudaStreamWaitEvent")


def ring_window(fn, devices, kernels_a_call: int, calls: int = 10,
                tries: int = 3) -> dict:
    """What ``calls`` calls of ``fn`` (after one outside the window) issue
    under ``torch.profiler``: device ops by name and the runtime API calls
    seen on the host. Fails on any device op other than B3's kernel (a
    memset, a fill, a copy), on a set-up call (``RING_SET_UP_CALLS``), and
    unless the host launched exactly ``kernels_a_call`` B3 kernels a call.
    ``kernel_ms`` is the mean device time of a B3 kernel seen (on peer
    ranks a card's kernel, its waits included); ``runtime_api_us_each``
    the host's mean time in each runtime call.
    A window can miss device events (PERF.md §7): fewer kernels seen than
    launched is reported (``seen_a_call``), and a window that saw none is
    taken again, up to ``tries`` windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    devices = list(dict.fromkeys(devices))
    fn()
    for d in devices:
        torch.cuda.synchronize(d)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            for d in devices:
                torch.cuda.synchronize(d)
        device_ops, api, api_us, ring_us = {}, {}, {}, 0.0
        for e in prof.key_averages():
            if not e.count:
                continue
            if e.device_type == DeviceType.CUDA:
                device_ops[e.key[:80]] = e.count
                if "ring_kernel" in e.key:
                    ring_us += e.self_device_time_total
            elif e.key.startswith("cuda"):
                api[e.key] = e.count
                api_us[e.key] = e.cpu_time_total / e.count
        kernels = sum(c for k, c in device_ops.items() if "ring_kernel" in k)
        if kernels:
            break
    other = {k: c for k, c in device_ops.items() if "ring_kernel" not in k}
    check(not other, f"B3 calls issued other device ops: {other}")
    # peer ranks launch cooperatively, virtual ranks plainly
    launched = api.get("cudaLaunchCooperativeKernel" if len(devices) > 1
                       else "cudaLaunchKernel", 0)
    check(launched == kernels_a_call * calls,
          f"B3 launched {launched} kernels for {calls} calls of "
          f"{kernels_a_call}: {api}")
    check(kernels <= launched, f"{kernels} B3 kernels seen, {launched} "
          "launched")
    set_up = {k: c for k, c in api.items() if k in RING_SET_UP_CALLS}
    check(not set_up, f"B3 calls after the first made set-up calls: {set_up}")
    return {"calls": calls, "kernels_a_call": kernels_a_call,
            "seen_a_call": kernels / calls,
            "kernel_ms": ring_us / kernels / 1e3 if kernels else None,
            "device_ops": device_ops, "runtime_api": api,
            "runtime_api_us_each": api_us}


def ring_enqueue(shards, mesh, runs: int = 7) -> dict:
    """The host's part of a B3 call, cards idle before each run (median ms
    of ``runs``): the wrapper's time to return (checks, outputs, streams,
    the launcher) and the launcher's alone (``_MeshState.launch`` on
    outputs allocated once: the ctypes call and the n launches). The
    launcher's launches bypass the wrapper, so ``RING_LAUNCHES`` does not
    count them: call this only after the main path's counts are read."""
    import ctypes

    import torch

    from entropy_coders_tpu_torch.kernels.build import load
    from entropy_coders_tpu_torch.parallel import rdma as R

    n = len(mesh)
    lib = load()
    state = R._STATES[mesh]
    outs = [torch.empty((n,) + tuple(shards[0].shape), dtype=shards[0].dtype,
                        device=d) for d in mesh]
    ptrs = ctypes.c_void_p * n
    ins = ptrs(*[t.data_ptr() for t in shards])
    out_ptrs = ptrs(*[t.data_ptr() for t in outs])
    streams = [s.cuda_stream for s in state.streams]
    chunk = shards[0].numel() * shards[0].element_size()

    def launcher():
        state.launch(lib, ins, out_ptrs, ptrs(), chunk, streams)

    out = {}
    for name, fn in (("wrapper_ms", lambda: R._ring_call(shards, mesh)),
                     ("launcher_ms", launcher)):
        times = []
        for _ in range(runs):
            for d in dict.fromkeys(mesh):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
        out[name + "_runs"] = times
    for d in dict.fromkeys(mesh):
        torch.cuda.synchronize(d)
    return out


def ring_full_width(shards, mesh):
    """B3 at full width on ``mesh``, held against the plain version
    (gather, and accumulate over the u32 words), then timed one call a run,
    as its plain version is: on virtual ranks by CUDA events on the card
    (``queued_ms`` beside: three calls queued a run, which hides the host's
    enqueue); on peer ranks by each card's events around a call (the
    slowest card) and on the host clock, every card synchronised. Beside
    them: the
    kernel alone (the profiler's ``window``) and the host's part of a call
    (``ring_enqueue``). The bound is the function's bytes: virtual ranks
    read each chunk once and write it n times, (n + n*n) * chunk over 3.35
    TB/s; peer ranks send (n-1) * chunk each over NVLink at 450 GB/s."""
    from entropy_coders_tpu_torch.parallel import rdma as R
    from entropy_coders_tpu_torch.tools.bench_data import cuda_ms

    n = len(mesh)
    peer = len(set(mesh)) == n
    chunk = shards[0].numel() * shards[0].element_size()
    worst = max(ring_case(shards, mesh), ring_case(shards, mesh, True))

    def call():
        R._ring_call(shards, mesh)

    out = {"n": n, "peer": peer, "chunk_shape": list(shards[0].shape),
           "chunk_bytes": chunk}
    if peer:
        out["bound_ms"] = (n - 1) * chunk / NVLINK_BYTES_PER_S * 1e3
        out["bound_by"] = "NVLink bytes"
        out["clock"] = "the slowest card's CUDA events; host clock beside"
        out["ms"], out["ms_runs"] = cards_ms(call, mesh)
        out["host_ms"], out["host_ms_runs"] = host_ms(call, mesh)
        out["plain_ms"], _ = host_ms(lambda: R._ring_call_ref(shards, mesh),
                                     mesh)
    else:
        out["bound_ms"] = (n + n * n) * chunk / HBM_BYTES_PER_S * 1e3
        out["bound_by"] = "bytes"
        out["clock"] = "CUDA events, one call a run"
        out["ms"], out["ms_runs"] = cuda_ms(call)
        out["queued_ms"], out["queued_ms_runs"] = cuda_ms(call, reps=3)
        out["plain_ms"], _ = cuda_ms(lambda: R._ring_call_ref(shards, mesh))
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["window"] = ring_window(call, mesh, n if peer else 1)
    out["enqueue"] = ring_enqueue(shards, mesh)
    out["max_abs_err"] = worst
    return out


def ring_topology(count: int) -> dict:
    """The cards' peer-access matrix (``torch.cuda.can_device_access_peer``)
    and ``nvidia-smi topo -m``, printed as they are: B3's peer design
    assumes every card reaches every other (NVSwitch)."""
    import torch

    access = [[None if i == j else torch.cuda.can_device_access_peer(i, j)
               for j in range(count)] for i in range(count)]
    try:
        r = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                           text=True, timeout=60)
        topo = r.stdout if r.returncode == 0 else (
            f"nvidia-smi topo -m failed ({r.returncode}): {r.stderr}")
    except (OSError, subprocess.TimeoutExpired) as e:
        topo = f"nvidia-smi topo -m failed: {e!r}"
    print(topo, flush=True)
    return {"peer_access": access, "all_pairs": all(
        access[i][j] for i in range(count) for j in range(count) if i != j)}


def phase_ring(data):
    import numpy as np
    import torch

    from entropy_coders_tpu_torch.normalize import normalize_batch
    from entropy_coders_tpu_torch.ops import pl_coder as PL
    from entropy_coders_tpu_torch.parallel import rdma as R

    dev = torch.device("cuda", 0)
    blocks_np = data.reshape(-1, BLOCK)
    blocks = torch.from_numpy(blocks_np).to(dev)
    bincount = np.bincount(data, minlength=256)
    cases, worst = {}, 0
    for n in (2, 3, 8):
        counts = rank_counts(blocks, n)
        check((counts.sum(0) == bincount).all(), "rank counts != bincount")
        err = ring_cases((dev,) * n, counts)
        cases[f"virtual_{n}"] = {"max_abs_err": err}
        worst = max(worst, err)

    # full width: n = 8 ranks, each one (264, 16384) u32 block of the
    # throughput point's B2 lane words
    L, k = 8, 16384
    nt, l2 = normalize_batch(np.stack([np.bincount(b, minlength=256)
                                       for b in blocks_np]), BLOCK, L)
    check((l2 == L).all(), f"table log raised to {l2}")
    W = PL.encode_w_bound(BLOCK // k - 1, L)
    words, _ = PL.encode_call(blocks, PL.tables_from_norm(nt, L, dev), k=k,
                              L=L, W=W)
    mesh = (dev,) * 8
    shards = list(words.unbind(0))
    gathered = R.ring_all_gather(words, mesh)
    check(torch.equal(_bits(gathered), _bits(words)),
          "ring_all_gather of the lane words != the words")
    full = ring_full_width(shards, mesh)
    worst = max(worst, full["max_abs_err"])

    count = torch.cuda.device_count()
    if count >= 2:
        peer = {"topology": ring_topology(count)}
        for n in sorted({2, min(count, 8)}):
            pmesh = tuple(torch.device("cuda", i) for i in range(n))
            err = ring_cases(pmesh, rank_counts(blocks, n))
            peer[f"peer_{n}"] = {"max_abs_err": err}
            worst = max(worst, err)
        # full width on n distinct cards: two calls on the mesh's cached
        # state, then one with another chunk size (133 of the 264 rows)
        pshards = [shards[i].to(d) for i, d in enumerate(pmesh)]
        epoch = R._STATES[pmesh].epoch
        for _ in range(2):
            worst = max(worst, ring_case(pshards, pmesh))
        worst = max(worst, ring_case(
            [s[:133].contiguous() for s in pshards], pmesh))
        check(R._STATES[pmesh].epoch == epoch + 3,
              "the peer mesh's state was set up again")
        peer["full_width"] = ring_full_width(pshards, pmesh)
        peer["full_width"]["nccl_all_gather"] = phase_nccl(
            n, tuple(shards[0].shape))
        worst = max(worst, peer["full_width"]["max_abs_err"])
    else:
        peer = "not run: 1 device"
    emit("ring", cases=cases, full_width=full, peer=peer, max_abs_err=worst)
    return worst, full, peer


def _ring_library(peer) -> dict:
    """B3's yardstick fields: NCCL's ``all_gather_into_tensor`` across the
    cards of the peer full-width case (device events, the slowest rank),
    with its host clock and the peer B3's device and host times and bound
    beside it; null on one card, with the reason."""
    if not isinstance(peer, dict):
        return {"library_ms": None,
                "library": "NCCL all_gather_into_tensor needs >= 2 cards; "
                           "this machine has 1"}
    fw = peer["full_width"]
    nccl = fw["nccl_all_gather"]
    return {"library_ms": nccl["device_ms"],
            "library": f"NCCL all_gather_into_tensor, {nccl['n']} cards, "
                       "the slowest rank's CUDA events",
            "library_host_ms": nccl["ms"], "peer_n": fw["n"],
            "peer_ms": fw["ms"], "peer_host_ms": fw["host_ms"],
            "peer_bound_ms": fw["bound_ms"]}


def _sync_all():
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _same_bytes(back: bytes, data) -> bool:
    import numpy as np

    return len(back) == len(data) and np.array_equal(
        np.frombuffer(back, np.uint8), data)


def _codec(T, P, mesh):
    """(compress, decompress) of the port on ``mesh``; None is no
    sharding, on ``cuda``."""
    if mesh is None:
        return (lambda d, **kw: T.compress(d, device="cuda", **kw),
                lambda f: T.decompress(f, device="cuda"))
    return (lambda d, **kw: P.compress(d, mesh, **kw),
            lambda f: P.decompress(f, mesh))


def mesh_turns(T, P, meshes, data, knobs, want, runs: int = 3,
               parent=None) -> dict:
    """compress + decompress of ``data`` on each mesh of ``meshes`` (name
    -> mesh, None for no sharding), one warm-up round, then ``runs``
    rounds in turns, the order reversed every other round (ABC, CBA, ...).
    With ``parent`` (the parent commit's port, ``parent_port``) its calls
    on each mesh take their turns too, as ``parent_<name>``. Host clock,
    every card synchronised before and after each call, and the host's
    time in each ``ect.*`` stage (``stage_clocks``: this commit's stages
    only); every frame must equal ``want`` and every round trip be exact.
    Medians, every run and the warm-up round (``*_s_cold``), in seconds;
    GB/s of raw input at the medians."""
    codecs = {name: (_codec(T, P, mesh), mesh)
              for name, mesh in meshes.items()}
    if parent is not None:
        codecs |= {f"parent_{name}": (_codec(*parent, mesh), mesh)
                   for name, mesh in meshes.items()}
    names = list(codecs)
    times = {n: {"compress_s": [], "decompress_s": [], "stages": []}
             for n in names}
    order, spent = [], {}
    with stage_clocks(spent):
        for r in range(runs + 1):
            for name in (names if r % 2 else names[::-1]):
                (comp, decomp), _ = codecs[name]
                spent.clear()
                _sync_all()
                t0 = time.perf_counter()
                frame = comp(data, **knobs)
                _sync_all()
                t1 = time.perf_counter()
                back = decomp(frame)
                _sync_all()
                t2 = time.perf_counter()
                check(frame == want, f"turns: the frame on {name} differs")
                check(_same_bytes(back, data), f"turns: round trip on {name}")
                if not r:  # round 0 warms the pinned staging and the caches
                    times[name].update(compress_s_cold=t1 - t0,
                                       decompress_s_cold=t2 - t1)
                    continue
                order.append(name)
                times[name]["compress_s"].append(t1 - t0)
                times[name]["decompress_s"].append(t2 - t1)
                times[name]["stages"].append(dict(spent))
    for name in names:
        t = times[name]
        for key in ("compress", "decompress"):
            t[f"{key}_median_s"] = statistics.median(t[f"{key}_s"])
            t[f"{key}_GBps"] = len(data) / t[f"{key}_median_s"] / 1e9
        stages = t.pop("stages")
        t["stage_median_ms"] = {
            st: statistics.median(x.get(st, 0.0) for x in stages) * 1e3
            for st in sorted(set().union(*stages))}
        mesh = codecs[name][1]
        t["ranks"] = 1 if mesh is None else len(mesh)
    return {"order": order, "input_bytes": len(data), "frame_bytes": len(want),
            **times}


def _interval_union(spans) -> float:
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_overlap(fn, tries: int = 3) -> dict:
    """What each card's device did during one call of ``fn``, from
    ``torch.profiler``'s device events (kernels, copies, memsets; not the
    ``ect.*`` ranges' mirrors): a card's window runs from its first event's
    start to its last's end, its busy time is the union of its events. The
    windows' union against their sum: serial shares give a union close to
    the sum, shares that run at once one near the largest window. A
    profile that saw no device event is taken again, up to ``tries``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        _sync_all()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            _sync_all()
        spans: dict = {}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                    and not e.name.startswith("ect.")):
                spans.setdefault(e.device_index, []).append(
                    (e.time_range.start, e.time_range.end))
        if spans:
            break
    if not spans:
        return {"device_events_seen": False}
    windows = {d: (min(a for a, _ in v), max(b for _, b in v))
               for d, v in sorted(spans.items())}
    union = _interval_union(windows.values())
    total = sum(b - a for a, b in windows.values())
    return {"device_events_seen": True, "cards": len(windows),
            "window_ms": {d: (b - a) / 1e3 for d, (a, b) in windows.items()},
            "busy_ms": {d: _interval_union(v) / 1e3
                        for d, v in sorted(spans.items())},
            "events": {d: len(v) for d, v in sorted(spans.items())},
            "union_ms": union / 1e3, "sum_ms": total / 1e3,
            "largest_ms": max(b - a for a, b in windows.values()) / 1e3,
            "union_over_sum": union / total if total else None}


def mesh_cards(T, P, data, knobs, runs: int = 3, want=None,
               parent=None) -> dict:
    """One card (``default_mesh(1)``) against every card
    (``default_mesh()``) on ``data``: in turns (``mesh_turns``, every
    frame equal to ``want``, by default the unsharded one-card frame; with
    ``parent``, the parent commit's port on both meshes in the same
    turns), then each port's compress and decompress once a mesh under the
    profiler (``device_overlap``), their frames and round trip checked."""
    if want is None:
        want = T.compress(data, device="cuda", **knobs)
    meshes = {"one_card": P.default_mesh(1), "all_cards": P.default_mesh()}
    out = {"knobs": knobs, **mesh_turns(T, P, meshes, data, knobs, want,
                                        runs, parent)}
    ports = {"": P} | ({"parent_": parent[1]} if parent else {})
    for prefix, port in ports.items():
        for name, mesh in meshes.items():
            frames, backs = [], []
            c = device_overlap(
                lambda: frames.append(port.compress(data, mesh, **knobs)))
            d = device_overlap(
                lambda: backs.append(port.decompress(want, mesh)))
            check(all(f == want for f in frames),
                  f"overlap: the frame on {prefix}{name} differs")
            check(all(_same_bytes(b, data) for b in backs),
                  f"overlap: round trip on {prefix}{name}")
            out[prefix + name]["overlap"] = {"compress": c, "decompress": d}
    return out


def parent_port():
    """The parent commit's port when ``build/parent`` holds a checkout of
    it, else None: its package imported under the name
    ``parent_ect_torch`` (this commit's modules untouched), as (package,
    its ``parallel``). Its libraries build from its own sources into its
    own ``build/``; where this commit's library of the same name (a hash
    of the sources and flags) is built, it is copied, not built again."""
    if "port" in _PARENT:
        return _PARENT["port"]
    import shutil

    from entropy_coders_tpu_torch.kernels import build as KB
    from entropy_coders_tpu_torch.native import build as NB

    name = "parent_ect_torch"
    pkg = ROOT / "build" / "parent" / "entropy_coders_tpu_torch"
    port = None
    if (pkg / "__init__.py").exists():
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        for mine, theirs in ((KB, f"{name}.kernels.build"),
                             (NB, f"{name}.native.build")):
            src = mine.library_path()
            dst = importlib.import_module(theirs).library_path()
            if src.exists() and dst.name == src.name and not dst.exists():
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(src, dst)
        port = (mod, importlib.import_module(f"{name}.parallel"))
    _PARENT["port"] = port
    return port


def compress_peak(fn) -> dict:
    """The device memory a compress ``fn()`` takes at its peak on each
    card (``torch.cuda.max_memory_allocated`` after a reset, less what was
    allocated before) and their sum."""
    import torch

    cards = range(torch.cuda.device_count())
    _sync_all()
    base = [torch.cuda.memory_allocated(i) for i in cards]
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    frame = fn()
    _sync_all()
    peaks = [torch.cuda.max_memory_allocated(i) - b
             for i, b in zip(cards, base)]
    return {"peak_bytes": sum(peaks), "peak_bytes_by_card": peaks,
            "frame_bytes": len(frame)}


@contextlib.contextmanager
def syncs_in(module, names, counts: dict):
    """While open, each call of ``module.<name>`` (for each of ``names``)
    runs under ``torch.cuda.set_sync_debug_mode("warn")``, and each warning
    of an operation that waited for a card (a blocking copy, a stream
    synchronisation, ``.item()``) adds where it was raised to
    ``counts[name]``, a list."""
    import warnings

    import torch

    saved = {n: getattr(module, n) for n in names}

    def watched(name, fn):
        def call(*args, **kwargs):
            counts.setdefault(name, [])
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                counts[name] += [f"{w.filename}:{w.lineno}: {w.message}"
                                 for w in seen if "synchronizing CUDA "
                                 "operation" in str(w.message)]
        return call

    for n, fn in saved.items():
        setattr(module, n, watched(n, fn))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _fse_bad_last_block(TF, frame: bytes, how: str) -> bytes:
    """``frame`` (MODE_FSE blocks with their headers) with its last
    block's payload zeroed (no marker bit: its share's checks refuse it)
    or one byte of it flipped (its decode ends at another length: its
    share's drain refuses it)."""
    pf = TF._parse_frame(frame)
    i = pf.n_blocks - 1
    check(pf.modes[i] == TF.MODE_FSE, "the last block is not MODE_FSE")
    sec = pf.section(i)
    payload = TF._read_block_header(sec)[2]
    at = int(pf.offs[i]) + len(sec) - len(payload)
    bad = bytearray(frame)
    if how == "no_marker":
        bad[at: at + len(payload)] = bytes(len(payload))
    else:
        bad[at + len(payload) // 2] ^= 0x5A
    return bytes(bad)


def sharded_shared_stream(T, P, data, virtual8) -> dict:
    """The shared-stream (MODE_FSE) groups on a mesh: the 128 MiB data at
    ``SHARED_STREAM["fse_default"]``'s knobs (128 KiB blocks, k = 1024,
    ``lanes=False``: 1,024 blocks in one L = 11 group). The unsharded call
    gives the pinned frame (sha256). One round trip on the 8 virtual
    ranks: D3/D4/D5 once a share a direction, no other kernel, no plain
    core on a CUDA tensor, and no operation inside a MODE_FSE dispatch
    that waits for the card (``syncs_in``). Then the unsharded call, the 8
    ranks and ``default_mesh()`` in turns (``mesh_turns``), the parent
    commit's port beside them when ``build/parent`` holds it; each one's
    compress peak device memory; 5 blocks over the 8 ranks, a range
    decode of them, and two corrupt copies that must raise ValueError (at
    the last share's dispatch, at its drain), each followed by an exact
    decode on the same ranks. With two cards or more, one card against all
    (``mesh_cards``, the parent beside)."""
    import numpy as np
    import torch

    from entropy_coders_tpu_torch import frame as TF

    knobs, want_bytes, want_sha = SHARED_STREAM["fse_default"]
    want = T.compress(data, device="cuda", **knobs)
    check(len(want) == want_bytes and _sha(want) == want_sha,
          f"sharded MODE_FSE: frame {len(want)} bytes, sha256 {_sha(want)}")
    pf = TF._parse_frame(want)
    log2 = np.array([TF._read_block_header(pf.section(i))[1]
                     for i in range(pf.n_blocks)])
    shares = sum(len(TF._shares(int((log2 == L).sum()), virtual8))
                 for L in np.unique(log2))

    # the watch sees a sync where there is one: ``.item()`` waits
    control, seen = types.SimpleNamespace(
        item=lambda: torch.ones(1, device="cuda").item()), {}
    with syncs_in(control, ("item",), seen):
        control.item()
    check(len(seen["item"]) == 1, f"the sync watch saw {seen} in .item()")
    c0, plain, syncs = _launch_counts_all(), {}, {}
    with plain_cores_on_cuda(plain), syncs_in(
            TF, ("_encode_dispatch_fse", "_decode_dispatch_fse"), syncs):
        frame = P.compress(data, virtual8, **knobs)
        back = P.decompress(frame, virtual8)
    got = {k: v - c0[k] for k, v in _launch_counts_all().items()}
    check(frame == want and _same_bytes(back, data),
          "sharded MODE_FSE: 8 ranks' frame or round trip")
    expect = {"decode": 0, "encode": 0, "merge": 0, "split": 0,
              "tables": 2 * shares, "fse_encode": shares,
              "fse_decode": shares,
              "histogram": len(TF._shares(len(data) // knobs["block_size"],
                                          virtual8)), "crc": 0}
    check(got == expect, f"sharded MODE_FSE: a round trip on 8 ranks "
          f"launched {got}, expected {expect}")
    check(not plain, f"sharded MODE_FSE: plain cores on CUDA: {plain}")
    check(not any(syncs.values()), f"sharded MODE_FSE: a dispatch waited "
          f"for the card: {syncs}")

    parent = parent_port()
    meshes = {"unsharded": None, "virtual_8": virtual8,
              "default_mesh": P.default_mesh()}
    turns = mesh_turns(T, P, meshes, data, knobs, want, parent=parent)
    ports = {"": (T, P)} | ({"parent_": parent} if parent else {})
    peaks = {prefix + name: compress_peak(
        lambda: _codec(*port, mesh)[0](data, **knobs))
        for prefix, port in ports.items() for name, mesh in meshes.items()}

    bs = knobs["block_size"]
    five = data[: 5 * bs]
    frame5 = P.compress(five, virtual8, **knobs)
    check(frame5 == T.compress(five, device="cuda", **knobs),
          "sharded MODE_FSE: 5 blocks over 8 ranks: frame != compress's")
    check(P.decompress(frame5, virtual8) == five.tobytes(),
          "sharded MODE_FSE: 5 blocks over 8 ranks: round trip")
    check(P.decompress(frame5, virtual8, start=bs + 7, length=2 * bs)
          == five[bs + 7: 3 * bs + 7].tobytes(),
          "sharded MODE_FSE: range decode")
    corrupt = {}
    for how, match in (("no_marker", "missing marker bit"),
                       ("flip", "corrupt frame")):
        try:
            P.decompress(_fse_bad_last_block(TF, frame5, how), virtual8)
            corrupt[how] = "no error"
        except ValueError as e:
            corrupt[how] = str(e)
        check(match in corrupt[how], f"sharded MODE_FSE: the {how} frame "
              f"gave {corrupt[how]!r}, expected a ValueError of {match!r}")
        check(P.decompress(frame5, virtual8) == five.tobytes(),
              f"sharded MODE_FSE: the decode after the {how} frame")

    cards = (mesh_cards(T, P, data, knobs, want=want, parent=parent)
             if torch.cuda.device_count() >= 2 else
             "one card: one card against all needs >= 2")
    return {"knobs": knobs, "frame_bytes": len(want), "sha256": _sha(want),
            "shares_8_ranks": shares, "launches_8_ranks": got,
            "dispatch_syncs": syncs, "parent": parent is not None,
            "meshes": turns, "compress_peak": peaks,
            "five_blocks_bytes": len(frame5), "corrupt": corrupt,
            "cards": cards}


def d6_on_8_ranks(T, P, TF, data, virtual8, single_frame) -> dict:
    """The throughput point compressed on 8 virtual ranks with a sync
    watch (``syncs_in``) over ``frame.histogram_blocks``: one D6 launch a
    share, and no operation inside a share's histogram that waits for the
    card (the watch first sees the one in an ``.item()`` control); the
    frame equals the unsharded one. Then the peak device memory of a
    compress (``compress_peak``) unsharded and on the 8 ranks, beside the
    parent commit's port's (its ``bincount`` route) when ``build/parent``
    holds it."""
    import torch

    from entropy_coders_tpu_torch.ops import histogram as H

    control, seen = types.SimpleNamespace(
        item=lambda: torch.ones(1, device="cuda").item()), {}
    with syncs_in(control, ("item",), seen):
        control.item()
    check(len(seen["item"]) == 1, f"the sync watch saw {seen} in .item()")
    syncs, h0 = {}, H.HIST_LAUNCHES
    with syncs_in(TF, ("histogram_blocks",), syncs):
        frame = P.compress(data, virtual8, **THROUGHPUT)
    launches = H.HIST_LAUNCHES - h0
    shares = len(TF._shares(len(data) // BLOCK, virtual8))
    check(frame == single_frame, "8 ranks: the frame differs")
    check(launches == shares, f"8 ranks: {launches} D6 launches for "
          f"{shares} shares")
    check(not any(syncs.values()), f"8 ranks: a histogram waited for the "
          f"card: {syncs}")
    parent = parent_port()
    ports = {"": (T, P)} | ({"parent_": parent} if parent else {})
    peaks = {prefix + name: compress_peak(
        lambda: _codec(*port, mesh)[0](data, **THROUGHPUT))
        for prefix, port in ports.items()
        for name, mesh in (("unsharded", None), ("virtual_8", virtual8))}
    return {"shares": shares, "launches": launches, "syncs": syncs,
            "compress_peak": peaks}


def phase_sharded(T, data, single_frame):
    """The shared-stream (MODE_FSE) groups on a mesh first
    (``sharded_shared_stream``), then the throughput point through
    parallel.compress/decompress; the unsharded call, eight virtual ranks
    and ``default_mesh()`` in turns; with two cards or more, one card
    against all of them at 128 MiB and at 1 GiB in config 4's shape
    (BASELINE.md: shared table, 4 MiB blocks, k=8192, the default
    table-log policy), each with the cards' device windows."""
    import numpy as np
    import torch

    from entropy_coders_tpu_torch import frame as TF
    from entropy_coders_tpu_torch import parallel as P
    from entropy_coders_tpu_torch.parallel import rdma as R

    dev = torch.device("cuda", 0)
    virtual8 = (dev,) * 8
    t0 = time.perf_counter()
    fse = sharded_shared_stream(T, P, data, virtual8)
    emit("sharded_shared_stream", **fse, seconds=time.perf_counter() - t0)
    turns = mesh_turns(T, P, {"unsharded": None, "virtual_8": virtual8,
                              "default_mesh": P.default_mesh()},
                       data, THROUGHPUT, single_frame)
    d6 = d6_on_8_ranks(T, P, TF, data, virtual8, single_frame)
    cards = {}
    if torch.cuda.device_count() >= 2:
        cards["throughput"] = mesh_cards(T, P, data, THROUGHPUT)
        big = load_testdata().gen_sequence(0.2, CONFIG4_BYTES, BENCH_SEED)
        cards["config4"] = mesh_cards(T, P, big, CONFIG4)
        del big
    check(len(single_frame) == THROUGHPUT_BYTES,
          f"sharded frame is {len(single_frame)} bytes")

    five = data[: 5 * BLOCK]
    frame5 = P.compress(five, virtual8, **THROUGHPUT)
    check(frame5 == T.compress(five, device="cuda", **THROUGHPUT),
          "5 blocks over 8 ranks: frame != compress's")
    check(P.decompress(frame5, virtual8) == five.tobytes(),
          "5 blocks over 8 ranks: round trip")
    check(P.decompress(frame5, virtual8, start=BLOCK + 7, length=2 * BLOCK)
          == five[BLOCK + 7: 3 * BLOCK + 7].tobytes(), "sharded range decode")

    hist = P.sharded_histogram(data.reshape(-1, BLOCK), virtual8)
    hist = hist.cpu().numpy()
    check((hist == np.bincount(data, minlength=256)).all(),
          "sharded_histogram != np.bincount")
    counts = rank_counts(torch.from_numpy(data.reshape(-1, BLOCK)).to(dev), 8)
    ring_total = R.ring_all_reduce_histograms(counts, virtual8).cpu().numpy()
    check((ring_total == hist).all(),
          "ring_all_reduce_histograms != sharded_histogram")
    s = TF.resolve_shared_table(ring_total, len(data), THROUGHPUT["table_log"],
                                True)
    t0 = time.perf_counter()
    shared = P.compress(data, virtual8, shared_table=True, **THROUGHPUT)
    shared_s = time.perf_counter() - t0
    check(TF._parse_frame(shared).shared_hdr == TF._write_header(*s),
          "shared header != the normalised ring total")
    check(P.decompress(shared, virtual8) == data.tobytes(),
          "sharded shared-table round trip")
    emit("sharded", meshes=turns, histogram_8_ranks=d6,
         five_blocks_bytes=len(frame5),
         shared_frame_bytes=len(shared), shared_compress_s=shared_s,
         shared_log2=s[1], cards=cards or
         "one card: one card against all needs >= 2")


def phase_nccl(n: int, shape) -> dict:
    """B3's yardstick: ``torch.distributed.all_gather_into_tensor`` over
    NCCL, one process a card (this script with ``--nccl-worker``), each
    rank's chunk one ``shape`` u32 block, as in the peer full-width ring.
    Returns rank 0's line: the medians over runs of the slowest rank's host
    time and of its CUDA-event time around the call, each rank's card
    synchronised before and after."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--nccl-worker",
         str(port), str(n), str(i), *map(str, shape)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n)]
    outs = []
    try:
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"nccl worker {i} timed out")
            if p.returncode != 0:
                raise SmokeFailure(f"nccl worker {i} failed "
                                   f"({p.returncode}):\n{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return json.loads(outs[0].strip().splitlines()[-1])


def nccl_worker(port: int, num: int, rank: int, rows: int, cols: int) -> int:
    """One process of ``phase_nccl``: rank ``rank`` of ``num`` on card
    ``rank``; rank 0 prints one JSON line."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=num, rank=rank)

    def chunk_of(r):
        g = torch.Generator().manual_seed(0xB3 + r)
        return torch.randint(-(1 << 31), 1 << 31, (rows, cols),
                             dtype=torch.int64, generator=g).to(torch.int32)

    chunk = chunk_of(rank).to(dev)
    out = torch.empty((num * rows, cols), dtype=torch.int32, device=dev)

    def call():
        dist.all_gather_into_tensor(out, chunk)

    for _ in range(2):
        call()
    torch.cuda.synchronize(dev)
    check(all(torch.equal(out.view(num, rows, cols)[r].cpu(), chunk_of(r))
              for r in range(num)),
          f"nccl all_gather (rank {rank}) != every rank's chunk")
    times, device = [], []
    for _ in range(7):
        dist.barrier(device_ids=[rank])
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        call()
        b.record()
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        device.append(a.elapsed_time(b))
    slowest = torch.tensor([times, device], dtype=torch.float64, device=dev)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    slowest, slowest_dev = slowest.tolist()
    if rank == 0:
        print(json.dumps({"n": num, "chunk_shape": [rows, cols],
                          "chunk_bytes": rows * cols * 4,
                          "ms": statistics.median(slowest),
                          "ms_runs": slowest,
                          "device_ms": statistics.median(slowest_dev),
                          "device_ms_runs": slowest_dev,
                          "clock": "host (ms) and CUDA events around the "
                                   "call on the rank's stream (device_ms), "
                                   "the slowest rank's each run, every card "
                                   "synchronised"}), flush=True)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_multihost(expected):
    """Two worker processes through parallel.multihost; ``expected`` maps
    each leg to the sha256 of its single-process frame."""
    port, num = _free_port(), 2
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--multihost-worker",
         str(port), str(num), str(i)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(num)]
    results = []
    try:
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"multihost worker {i} timed out")
            if p.returncode != 0:
                raise SmokeFailure(f"multihost worker {i} failed "
                                   f"({p.returncode}):\n{err[-4000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in results:
        for leg, sha in expected.items():
            check(r["legs"][leg]["sha256"] == sha,
                  f"worker {r['rank']} {leg} frame != the single-process one")
        check(min(r["launches"].values()) > 0,
              f"worker {r['rank']} never launched a kernel: {r['launches']}")
    emit("multihost", processes=num, workers=results)


def multihost_worker(port: int, num: int, rank: int) -> int:
    """One process of the ``multihost`` phase: prints one JSON line."""
    import torch
    import torch.distributed as dist

    from entropy_coders_tpu_torch.ops import pl_coder as PL
    from entropy_coders_tpu_torch.parallel import multihost as MH

    MH.init_distributed(f"127.0.0.1:{port}", num, rank)
    data = load_testdata().gen_sequence(0.2, BENCH_SIZE, BENCH_SEED)
    n_blocks = len(data) // BLOCK
    lo, hi = MH.owned_blocks(n_blocks)
    PL.DECODE_LAUNCHES = 0
    PL.ENCODE_LAUNCHES = 0
    legs = {}
    for leg, kw in MULTIHOST_LEGS.items():
        t0 = time.perf_counter()
        frame = MH.compress(data, **THROUGHPUT, **kw)
        compress_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = MH.decompress(frame)
        decompress_s = time.perf_counter() - t0
        check(back == data.tobytes(), f"multihost {leg} round trip")
        start, local = MH.decompress(frame, assemble=False)
        check(start == lo * BLOCK and local == data[lo * BLOCK: hi * BLOCK]
              .tobytes(), f"multihost {leg}: owned range differs")
        legs[leg] = {"sha256": hashlib.sha256(frame).hexdigest(),
                     "frame_bytes": len(frame), "compress_s": compress_s,
                     "decompress_s": decompress_s}
    print(json.dumps({"rank": rank,
                      "device": str(MH._local_device(None, None)),
                      "owned_blocks": [lo, hi], "legs": legs,
                      "launches": {"decode": PL.DECODE_LAUNCHES,
                                   "encode": PL.ENCODE_LAUNCHES,
                                   **_device_host_counts()}}),
          flush=True)
    dist.destroy_process_group()
    return 0


# --- the shared-stream coder (D4, D5) -----------------------------------------

# The shared-stream points: the 128 MiB bench data at 128 KiB blocks with
# lanes=False, so that every block takes MODE_FSE through D4/D5 (one
# table-log group of 1,024 blocks at L = 11). Bytes and sha256 of the frames
# the JAX package writes for the same input and knobs
# (entropy_coders_tpu.frame.compress on the CPU).
SHARED_STREAM = {
    "fse_default": (dict(block_size=128 * 1024, k=1024, lanes=False),
                    61_567_232, "4775558baa0893e72a6185e799c1c3200cd61e618a6a"
                    "8c3dc3eac57491323015"),
    "fse_k2": (dict(block_size=128 * 1024, k=2, lanes=False), 60_663_243,
               "4180f3c493eb240a9c1c57f2e760fcf472cb9c3a4a0e2935a2ec765aec7f"
               "3b6d"),
}
# D4/D5 against their plain versions on the card: (k, L, bytes a block,
# blocks, alphabet), every k and table log of the kernels' range that
# matters (one lane a thread up to 1,024 lanes, two past it), each block
# its own table, padding slots wherever n - k is not a multiple of k; the
# main path's own launch shapes last: the default point's 777-byte tail (k
# = n = 777, L = 7, one round of padding slots only) and golden
# frame_pl_crc's (k = 256, L = 7)
SS_CASES = [(1, 12, 1025, 2, 64), (2, 5, 1501, 2, 20), (3, 8, 1000, 2, 256),
            (4, 11, 2051, 3, 256), (33, 15, 33 * 40 + 7, 2, 256),
            (127, 11, 127 * 20 + 5, 2, 256), (1000, 8, 1000 * 8 + 13, 2, 256),
            (1024, 12, 1024 * 6, 2, 256), (2000, 15, 2000 * 5 + 77, 2, 256),
            (777, 7, 777, 1, 24), (256, 7, 777, 1, 24)]
SS_CORRUPT = ("flip", "flip_many", "truncated", "zeroed_top", "short",
              "past_words", "marker_off")
# the blocks of a point's launch shape the plain versions run on, at the
# full round count: all 1,024 at k = 1024 (127 rounds), the first two at
# k = 2 (65,535 rounds of ~50 small torch ops, ~1 s of plain loop a
# thousand rounds whatever the blocks)
SS_PLAIN_BLOCKS = {"fse_default": 1024, "fse_k2": 2}


def _ss_norm(rng, B: int, L: int, alphabet: int):
    """B valid normalizations to 2^L slots over ``alphabet`` of the 256
    symbols (a few at -1), each block its own."""
    import numpy as np

    size = 1 << L
    a = min(alphabet, size)
    nt = np.zeros((B, 256), np.int32)
    for b in range(B):
        sym = rng.choice(256, a, replace=False)
        counts = 1 + rng.multinomial(size - a, rng.dirichlet(np.ones(a)))
        counts[(rng.random(a) < 0.1) & (counts == 1)] = -1
        nt[b, sym] = counts
    return nt


def _ss_inputs(blocks, nt, k: int, L: int):
    """D4's and D5's inputs on the card for the host blocks (B, n) and their
    normalized counts, the tables from the port's C++ build."""
    import numpy as np
    import torch

    from entropy_coders_tpu_torch import native
    from entropy_coders_tpu_torch.ops import coder as C
    from entropy_coders_tpu_torch.ops.unsigned import to_device

    n = blocks.shape[1]
    m, R, valid, finish, W = C.encode_layout(n, k)
    syms, init = C.blocks_to_syms(blocks, m, R, k)
    table, tt_bits, tt_fs = native.build_encode_tables(nt, L)
    dev = "cuda"
    return {"k": k, "L": L, "m": m, "R": R, "W": W, "blocks": blocks,
            "nt": nt,
            "enc": (torch.from_numpy(np.ascontiguousarray(syms)).to(dev),
                    torch.from_numpy(valid).to(dev),
                    torch.from_numpy(np.ascontiguousarray(init)).to(dev),
                    torch.from_numpy(finish).to(dev),
                    (to_device(table, dev), to_device(tt_bits, dev),
                     to_device(tt_fs, dev))),
            "packed": to_device(native.build_decode_tables(nt, L), dev)}


def _ss_decode_inputs(words, total):
    """The container's decode inputs from an encode: the words (uint32) to
    the payload's last byte plus two zero guard words; the start at the
    marker bit."""
    import torch

    from entropy_coders_tpu_torch.ops.unsigned import signed_view

    Wd = (int(total.max()) + 7) // 8
    Wd = -(-Wd // 4) + 2
    out = torch.zeros((words.shape[0], Wd), dtype=torch.int32,
                      device=words.device)
    w = min(Wd, words.shape[1])
    out[:, :w] = signed_view(words[:, :w])
    return out.view(torch.uint32), total - 1


def _ss_diff(got, want) -> int:
    return max(max_abs_diff(g, w) for g, w in zip(got, want))


def _ss_corrupt(how, words, total, rng):
    """A corrupted or truncated copy of the decode inputs."""
    import torch

    from entropy_coders_tpu_torch.ops.unsigned import as_int64, int64_to_u32

    w = as_int64(words)
    t = total.clone()
    nbits = int(t.max())
    if how == "flip":
        for b in range(w.shape[0]):
            bit = int(rng.integers(0, int(t[b])))
            w[b, bit >> 5] ^= 1 << (bit & 31)
    elif how == "flip_many":
        w ^= torch.from_numpy((rng.random(tuple(w.shape)) < 0.05)
                              .astype("int64") << 7).to(w.device)
    elif how == "truncated":
        t = t - nbits // 3
    elif how == "zeroed_top":
        w[:, nbits // 64:] = 0
    elif how == "short":
        t = torch.full_like(t, 3)
    elif how == "past_words":
        t = t + 32 * w.shape[1] + 5
    else:
        t = t + 1
    return int64_to_u32(w), t


def _ss_message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def ss_kernel_cases() -> dict:
    """D4 and D5 against ``encode_core_ref`` / ``decode_core_ref`` on the
    same CUDA tensors, exactly: ``SS_CASES`` clean (round trip to the
    blocks), each with the corrupted and truncated decodes of
    ``SS_CORRUPT`` (all five outputs), and with an error word (a table too
    small: D4's index check; words too short for the start: D5's bit
    offset check), the message the plain checked version raises."""
    import numpy as np
    import torch

    from entropy_coders_tpu_torch.ops import coder as C

    rng = np.random.default_rng(BENCH_SEED + 14)
    worst, rows = 0, []
    for k, L, n, B, alphabet in SS_CASES:
        nt = _ss_norm(rng, B, L, alphabet)
        p = np.where(nt == -1, 1, nt).astype(np.float64)
        blocks = np.stack([rng.choice(256, n, p=r / r.sum()) for r in p]
                          ).astype(np.uint8)
        inp = _ss_inputs(blocks, nt, k, L)
        kw = dict(k=k, L=L, W=inp["W"])
        words, total = C.encode_core(*inp["enc"], **kw)
        rwords, rtotal = C.encode_core_ref(*inp["enc"], **kw)
        err = _ss_diff((words, total), (rwords, rtotal))
        dw, dt = _ss_decode_inputs(words, total)
        R = inp["R"] + 1
        got = C.decode_core(dw, dt, inp["packed"], k=k, L=L, R=R)
        err = max(err, _ss_diff(got, C.decode_core_ref(dw, dt, inp["packed"],
                                                       k=k, L=L, R=R)))
        syms, emit, finals, done, _ = got
        check(bool(done.all()) and bool((emit == inp["m"]).all()),
              f"shared_stream k={k} L={L}: a clean decode did not finish")
        back = torch.cat([syms.reshape(B, -1)[:, : inp["m"]], finals], 1)
        check(bool((back.cpu().numpy() == blocks).all()),
              f"shared_stream k={k} L={L}: round trip")
        corrupt = {}
        for how in SS_CORRUPT:
            cw, ct = _ss_corrupt(how, dw, dt, rng)
            got = C.decode_core(cw, ct, inp["packed"], k=k, L=L, R=R)
            e = _ss_diff(got, C.decode_core_ref(cw, ct, inp["packed"], k=k,
                                                L=L, R=R))
            corrupt[how] = {"max_abs_err": e,
                            "done": int(got[3].sum()),
                            "emit": got[1].tolist()}
            err = max(err, e)
        # the error words: the plain checked versions' messages
        syms_t, valid, init, finish, (table, tt_bits, tt_fs) = inp["enc"]
        small = (table[:, : table.shape[1] // 4].contiguous(), tt_bits, tt_fs)
        pairs = [(lambda f: f(syms_t, valid, init, finish, small, **kw,
                              checked=True)),
                 (lambda f: f(dw[:, :3].contiguous(), dt, inp["packed"], k=k,
                              L=L, R=R, checked=True))]
        msgs = [(_ss_message(lambda: fn(C.encode_core if i == 0
                                        else C.decode_core)),
                 _ss_message(lambda: fn(C.encode_core_ref if i == 0
                                        else C.decode_core_ref)))
                for i, fn in enumerate(pairs)]
        check(all(a == b and a is not None for a, b in msgs),
              f"shared_stream k={k} L={L}: checked messages {msgs}")
        torch.cuda.synchronize()
        check(err == 0, f"shared_stream k={k} L={L}: kernel != plain "
              f"version by {err}")
        worst = max(worst, err)
        rows.append({"k": k, "L": L, "n": n, "B": B, "R": inp["R"],
                     "max_abs_err": err, "corrupt": corrupt,
                     "checked": [m for m, _ in msgs]})
    return {"cases": rows, "max_abs_err": worst}


def _ss_bytes(kind: str, inp: dict, Wd: int, R: int) -> int:
    """The bytes a launch must move: each input read once, each output
    written once (scratch excluded). D4's output is all W words of a block
    (the JAX function's (B, W); D4 stores the words past the stream as
    zeros, so the launch writes every one)."""
    B, Rk, k = inp["blocks"].shape[0], inp["R"] * inp["k"], inp["k"]
    size = 1 << inp["L"]
    if kind == "encode":
        return (B * Rk + Rk + B * k + 8 * k + 2 * B * size + 2048 * B
                + 4 * B * inp["W"] + 8 * B)
    return 4 * B * Wd + 8 * B + 4 * B * size + B * R * k + B * k + 17 * B


def _ss_chain_cycles(kind: str, lat: dict) -> float:
    """A floor of one round's dependent chain, from the card's measured
    latencies (``csrc/latency.cu``): D4 state -> (tt_bits + state) >> 16
    (an add and a shift) -> state >> bits (a shift) -> + find_state (an
    add) -> the next state (a shared-memory load); D5 state -> its entry (a
    shared-memory load) -> the bit count (a shift) -> c - prefix and the
    read's shift (an add and a shift) -> the mask (LOP3) -> the state.
    The scan's shuffles and barrier and the payload read are not counted."""
    if kind == "encode":
        return lat["ADD_SHF"] + lat["SHF"] + lat["IMAD"] + lat["LDS"]
    return lat["LDS"] + lat["SHF"] + lat["ADD_SHF"] + lat["LOP3"]


def _ss_launchers(inp: dict, dw, dt, R: int, lib=None, path: int = -1):
    """D4's and D5's launchers of ``lib`` (this commit's library, or a
    parent's from ``device_host.load_parent``: its scratch allocated once
    where its launchers take some) on preallocated outputs, what the
    kernels alone take; every call writes every output word anew. ``path``
    names the kernel (``ect_fse_*_path``: 0 D5 one-thread, 1 wide, 2
    one-warp), -1 the launch rule's."""
    import torch

    from entropy_coders_tpu_torch.kernels import build as KB
    from entropy_coders_tpu_torch.kernels.launch import launch

    lib = KB.load() if lib is None else lib
    syms, valid, init, finish, (table, tt_bits, tt_fs) = inp["enc"]
    B, k, L = syms.shape[0], inp["k"], inp["L"]
    dev = syms.device
    size = table.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = torch.empty((B, inp["W"]), dtype=torch.int32, device=dev)
    total = torch.empty(B, dtype=torch.int64, device=dev)
    out_syms = torch.empty((B, R, k), dtype=torch.uint8, device=dev)
    emit = torch.empty(B, dtype=torch.int64, device=dev)
    finals = torch.empty((B, k), dtype=torch.uint8, device=dev)
    done = torch.empty(B, dtype=torch.bool, device=dev)
    cursor = torch.empty(B, dtype=torch.int64, device=dev)
    enc_args = [syms.data_ptr(), valid.data_ptr(), init.data_ptr(),
                finish.data_ptr(), table.data_ptr(), tt_bits.data_ptr(),
                tt_fs.data_ptr(), words.data_ptr(), total.data_ptr(), None]
    dec_args = [dw.data_ptr(), dt.data_ptr(), inp["packed"].data_ptr(),
                out_syms.data_ptr(), emit.data_ptr(), finals.data_ptr(),
                done.data_ptr(), cursor.data_ptr(), None]
    if getattr(lib, "fse_scratch", False):  # the parent's launchers
        fstate = torch.empty((B, k), dtype=torch.int32, device=dev)
        sbits = torch.empty(tuple(syms.shape), dtype=torch.uint8, device=dev)
        svals = torch.empty(tuple(syms.shape), dtype=torch.int16, device=dev)
        enc_args += [sbits.data_ptr(), svals.data_ptr(), fstate.data_ptr()]
        dec_args += [fstate.data_ptr()]
    enc_args += [B, inp["R"], k, L, size, inp["W"], stream]
    dec_args += [B, dw.shape[1], k, L, size, R, stream]
    if path >= 0:
        enc = functools.partial(lib.ect_fse_encode_path, path)
        dec = functools.partial(lib.ect_fse_decode_path, path)
        enc.__name__, dec.__name__ = "ect_fse_encode_path", \
            "ect_fse_decode_path"
    else:
        enc, dec = lib.ect_fse_encode, lib.ect_fse_decode

    def encode():
        launch(enc, *enc_args)

    def decode():
        launch(dec, *dec_args)

    return encode, decode, (words.view(torch.uint32), total), (
        out_syms, emit, finals, done, cursor)


def ss_in_turns(inp: dict, dw, dt, R: int) -> dict | None:
    """D4 and D5 of the parent commit (``build/parent``, when it has them)
    and of this one at ``inp``'s launch shape in turns (old, new, new,
    old; ``kernels_in_turns``), outputs equal."""
    old = parent_kernels()[1]
    if old is None or not old.fse:
        return None
    runs = {}

    def call(lib, kind):
        if id(lib) not in runs:
            runs[id(lib)] = _ss_launchers(inp, dw, dt, R, lib)
        encode, decode, enc_out, dec_out = runs[id(lib)]
        (encode if kind == "encode" else decode)()
        return enc_out if kind == "encode" else dec_out

    out = {kind: kernels_in_turns(lambda lib, kind=kind: call(lib, kind),
                                  f"shared_stream k={inp['k']} {kind}")
           for kind in ("encode", "decode")}
    del runs
    return out


def _ss_plain(fn, runs: int):
    """The plain version's outputs and its host-clock time in ms (the
    median of the calls after the first, or the one call), the card
    synchronised around each call."""
    import torch

    times, out = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times[1:] or times), times


def _ss_kernels_timed(inp: dict, lat: dict, mhz: float) -> dict:
    """D4 and D5 at ``inp``'s shape by CUDA events: the launcher alone
    (``ms``: the kernels) and a wrapper call (``wrapper_ms``: its
    allocations), the launchers' outputs first held against the
    wrappers' (``launcher_vs_wrapper_err``, the one call path against the
    other, not against the plain versions); the bound, the larger of the
    bytes over 3.35 TB/s and the chain floor times the rounds
    (``bound_by`` "operations" when the chain binds). Returns the wrappers'
    outputs too."""
    import torch

    from entropy_coders_tpu_torch.ops import coder as C
    from entropy_coders_tpu_torch.tools.bench_data import cuda_ms

    k, L = inp["k"], inp["L"]
    kw = dict(k=k, L=L, W=inp["W"])
    words, total = C.encode_core(*inp["enc"], **kw)
    dw, dt = _ss_decode_inputs(words, total)
    R = inp["R"] + 1
    dec = C.decode_core(dw, dt, inp["packed"], k=k, L=L, R=R)
    encode, decode, enc_out, dec_out = _ss_launchers(inp, dw, dt, R)
    encode()
    decode()
    torch.cuda.synchronize()
    err = max(_ss_diff(enc_out, (words, total)), _ss_diff(dec_out, dec))
    check(err == 0, f"shared_stream launchers != wrappers by {err}")
    B = inp["blocks"].shape[0]
    out = {"B": B, "k": k, "L": L, "R": inp["R"], "W": inp["W"],
           "Wd": dw.shape[1], "launcher_vs_wrapper_err": err}
    calls = {"encode": (encode, lambda: C.encode_core(*inp["enc"], **kw),
                        inp["R"]),
             "decode": (decode, lambda: C.decode_core(dw, dt, inp["packed"],
                                                      k=k, L=L, R=R), R)}
    for kind, (alone, wrapper, rounds) in calls.items():
        ms, runs = cuda_ms(alone, runs=5, warmup=1)
        wrapper_ms, _ = cuda_ms(wrapper, runs=5, warmup=1)
        nbytes = _ss_bytes(kind, inp, dw.shape[1], R)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        chain = _ss_chain_cycles(kind, lat)
        chain_ms = rounds * chain / (mhz * 1e6) * 1e3
        bound_ms = max(bytes_ms, chain_ms)
        out[kind] = {"ms": ms, "ms_runs": runs, "wrapper_ms": wrapper_ms,
                     "bytes": nbytes, "bytes_ms": bytes_ms,
                     "chain_cycles_a_round": chain, "chain_ms": chain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "bytes" if bytes_ms >= chain_ms
                     else "operations",
                     "binds": "bytes" if bytes_ms >= chain_ms else "chain",
                     "share_of_bound": bound_ms / ms,
                     "GBps": inp["blocks"].size / ms / 1e6,
                     "launch": ss_launch_info(kind, k, L,
                                              inp["packed"].shape[1])}
    return out, (words, total), (dw, dt), dec


def ss_time_shape(inp: dict, lat: dict, mhz: float,
                  plain_blocks: int) -> dict:
    """D4 and D5 at ``inp``'s launch shape (``_ss_kernels_timed``), then
    the wrappers against the plain versions on the same CUDA tensors,
    exactly (``max_abs_err``: every output, D5's cursor included), on the
    first ``plain_blocks`` blocks at the full round count (``plain``: the
    plain versions' host-clock time there, the kernels' beside it)."""
    from entropy_coders_tpu_torch.ops import coder as C

    out, enc, (dw, dt), dec = _ss_kernels_timed(inp, lat, mhz)
    out["in_turns"] = ss_in_turns(inp, dw, dt, inp["R"] + 1)
    B = out["B"]
    if plain_blocks < B:
        sub = _ss_inputs(inp["blocks"][:plain_blocks],
                         inp["nt"][:plain_blocks], inp["k"], inp["L"])
        sub_out, enc, (dw, dt), dec = _ss_kernels_timed(sub, lat, mhz)
    else:
        sub, sub_out = inp, out
    k, L, R = sub["k"], sub["L"], sub["R"] + 1
    runs = 3 if sub["R"] < 1024 else 1  # one call of a long plain loop
    ref_enc, enc_ms, enc_runs = _ss_plain(
        lambda: C.encode_core_ref(*sub["enc"], k=k, L=L, W=sub["W"]), runs)
    ref_dec, dec_ms, dec_runs = _ss_plain(
        lambda: C.decode_core_ref(dw, dt, sub["packed"], k=k, L=L, R=R),
        runs)
    err = max(_ss_diff(enc, ref_enc), _ss_diff(dec, ref_dec))
    check(err == 0, f"shared_stream k={k}: the wrappers differ from the "
          f"plain versions by {err} at B = {sub_out['B']}, R = {sub['R']}")
    out["max_abs_err"] = err
    out["plain"] = {"B": sub_out["B"], "k": k, "L": L, "R": sub["R"],
                    "max_abs_err": err,
                    "encode": {"plain_ms": enc_ms, "plain_runs": enc_runs,
                               "ms": sub_out["encode"]["ms"]},
                    "decode": {"plain_ms": dec_ms, "plain_runs": dec_runs,
                               "ms": sub_out["decode"]["ms"]}}
    return out


# the k sweep: 1,024 blocks of 128 KiB at L = 11 (the default point's
# launch shape) at each k, both kernels where both take k
SS_SWEEP_K = (1, 2, 4, 8, 32, 128, 1024)
SS_LAUNCH_KEYS = ("kernel", "lanes", "threads", "smem_bytes", "registers",
                  "local_bytes", "ctas_per_sm", "ring_words", "sub_threads",
                  "blocks_per_cta")


def ss_launch_info(kind: str, k: int, L: int, size: int,
                   path: int = -1) -> dict:
    """What a D4/D5 launch takes on this card (``ect_fse_launch_info``):
    the kernel (0 D5 one-thread, 1 wide, 2 one-warp), its lanes a thread,
    CTA, shared memory, registers and local memory a thread (the
    compiler's), resident CTAs an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), rings, blocks a
    CTA."""
    import ctypes

    from entropy_coders_tpu_torch.kernels import build as KB

    out = (ctypes.c_int * 10)()
    rc = KB.load().ect_fse_launch_info(0 if kind == "decode" else 1, path, k,
                                       L, size, 0, out)
    check(rc == 0, f"ect_fse_launch_info({kind}, {path}, k={k}): {rc}")
    return dict(zip(SS_LAUNCH_KEYS, list(out)))


# each kernel's round loop in the SASS: (function pattern, ops the loop
# holds, the op that ranks the loops that hold them)
SS_SASS = {("decode", 0): (r"fse_decode_oneILi{n}ELb0E",
                           ("STS.U8", "LDS", "LDG"), "LDS"),
           ("decode", 1): (r"fse_decode_wideILi{n}ELb0E", ("SHFL.UP",), None),
           ("decode", 2): (r"fse_decode_warpILb0E", ("SHFL.IDX", "LDS"),
                           "LDS"),
           ("encode", 1): (r"fse_encode_wideILi{n}ELb0E",
                           ("SHFL.UP", "LDS.U16"), "LDS.U16"),
           ("encode", 2): (r"fse_encode_warpILb0E", ("LDS.64", "LDS.U16"),
                           None)}
# each direction's kernels (path numbers of ``ect_fse_*_path``) and the
# most lanes each takes: 0 D5's one-thread kernel, 2 the one-warp ones, 1
# the wide ones
SS_PATHS = {"decode": ((0, 2), (2, 32), (1, 1 << 16)),
            "encode": ((2, 32), (1, 1 << 16))}


def ss_paths(kind: str, k: int) -> list:
    """The kernels of ``kind`` that take k lanes."""
    return [p for p, top in SS_PATHS[kind] if k <= top]
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_round_loop(text: str, kind: str, path: int, lanes: int) -> dict:
    """The round loop of the kernel's SASS: of the loops (a backward branch
    and the code from its target) that hold the ops ``SS_SASS`` names and
    hold no other such loop, the one with the most of its ranking op (the
    shortest where it names none). Its static instruction count, all paths
    of its body, and its most frequent ops."""
    from collections import Counter

    from entropy_coders_tpu_torch.tools import lane_shapes as LS

    pat, must, rank = SS_SASS[(kind, path)]
    body = LS.sass_function(text, pat.format(n=lanes))
    if body is None:
        return {"found": False}
    insns, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L\w+):", line)
        if lab:
            pending.append(lab.group(1))
        m = _SASS_LINE.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    loops = []
    for addr, op, args in insns:
        if not op.startswith("BRA"):
            continue
        hexa = re.search(r"0x([0-9a-f]+)", args)
        lab = re.search(r"(\.L\w+)", args)
        target = (int(hexa.group(1), 16) if hexa
                  else labels.get(lab.group(1)) if lab else None)
        if target is not None and target < addr:
            loops.append((target, addr))
    cands = []
    for lo, hi in loops:
        ops = [op for a, op, _ in insns if lo <= a <= hi]
        if all(any(o.startswith(m) for o in ops) for m in must):
            cands.append((lo, hi, ops))
    inner = [c for c in cands
             if not any(c[0] <= d[0] and d[1] <= c[1] and d[:2] != c[:2]
                        for d in cands)]
    if not inner:
        return {"found": False, "loops": len(loops)}
    ops = min(inner, key=lambda c: (
        -sum(o.startswith(rank) for o in c[2]) if rank else 0,
        len(c[2])))[2]
    return {"found": True, "instructions": len(ops),
            "top_ops": Counter(o.split(".")[0] for o in ops).most_common(8)}


def ss_kernel_info(text: str, L: int, size: int) -> dict:
    """Each kernel's launch (``ss_launch_info``) and round loop
    (``sass_round_loop``) at the two points' k: 1,024 (the wide kernels)
    and 2 (every kernel that takes it)."""
    out = {}
    for kind in ("decode", "encode"):
        for k in (1024, 2):
            for path in ss_paths(kind, k):
                info = ss_launch_info(kind, k, L, size, path)
                info["round_loop"] = sass_round_loop(text, kind, path,
                                                     info["lanes"])
                out[f"{kind}_k{k}_kernel{path}"] = info
    return out


def ss_plain_first_block(sub: dict, enc, dw, dt, dec, R: int) -> int:
    """The largest difference between the kernels' outputs on the first
    block and the plain versions' on the same inputs (run on the host: a
    Python loop of R rounds)."""
    from entropy_coders_tpu_torch.ops import coder as C

    syms, valid, init, finish, tables = sub["enc"]
    k, L = sub["k"], sub["L"]
    ref = C.encode_core_ref(syms[:1].cpu(), valid.cpu(), init[:1].cpu(),
                            finish.cpu(), tuple(t[:1].cpu() for t in tables),
                            k=k, L=L, W=sub["W"])
    err = _ss_diff([t[:1].cpu() for t in enc], ref)
    ref = C.decode_core_ref(dw[:1].cpu(), dt[:1].cpu(),
                            sub["packed"][:1].cpu(), k=k, L=L, R=R)
    return max(err, _ss_diff([t[:1].cpu() for t in dec], ref))


def ss_sweep(inp: dict, lat: dict, mhz: float) -> dict:
    """D4 and D5 over ``SS_SWEEP_K`` on the default point's blocks and
    tables (1,024 blocks of 128 KiB, L = 11): at each k the wrappers (the
    launch rule's kernel), then each kernel that takes k, its outputs equal
    to the wrappers' and its time by CUDA events beside the bound; the
    wrappers against the plain versions on the first block. Where the
    kernels' times cross places the rule's thresholds."""
    import torch

    from entropy_coders_tpu_torch.ops import coder as C
    from entropy_coders_tpu_torch.tools.bench_data import cuda_ms

    L, size = inp["L"], inp["packed"].shape[1]
    rows = {}
    for k in SS_SWEEP_K:
        t0 = time.perf_counter()
        sub = _ss_inputs(inp["blocks"], inp["nt"], k, L)
        words, total = C.encode_core(*sub["enc"], k=k, L=L, W=sub["W"])
        dw, dt = _ss_decode_inputs(words, total)
        R = sub["R"] + 1
        dec = C.decode_core(dw, dt, sub["packed"], k=k, L=L, R=R)
        row = {"k": k, "R": sub["R"], "B": len(inp["blocks"]),
               "rule": {kind: ss_launch_info(kind, k, L, size)["kernel"]
                        for kind in ("encode", "decode")}}
        for kind, rounds in (("encode", sub["R"]), ("decode", R)):
            nbytes = _ss_bytes(kind, sub, dw.shape[1], R)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            chain_ms = rounds * _ss_chain_cycles(kind, lat) / (mhz * 1e6) * 1e3
            row[f"{kind}_bound_ms"] = max(bytes_ms, chain_ms)
            row[f"{kind}_bound_by"] = ("bytes" if bytes_ms >= chain_ms
                                       else "operations")
        for kind in ("encode", "decode"):
            for path in ss_paths(kind, k):
                encode, decode, enc_out, dec_out = _ss_launchers(
                    sub, dw, dt, R, path=path)
                fn, got, want = ((encode, enc_out, (words, total))
                                 if kind == "encode" else
                                 (decode, dec_out, dec))
                fn()
                torch.cuda.synchronize()
                err = _ss_diff(got, want)
                check(err == 0, f"shared_stream sweep k={k}: {kind} kernel "
                      f"{path} != the wrapper by {err}")
                ms, runs = cuda_ms(fn, runs=3, warmup=1)
                row.setdefault(f"kernel{path}", {})[kind] = {
                    "ms": ms, "ms_runs": runs, "max_abs_err": err,
                    "share_of_bound": row[f"{kind}_bound_ms"] / ms,
                    **ss_launch_info(kind, k, L, size, path)}
                del encode, decode, enc_out, dec_out
        row["plain_first_block_err"] = ss_plain_first_block(
            sub, (words, total), dw, dt, dec, R)
        check(row["plain_first_block_err"] == 0, f"shared_stream sweep "
              f"k={k}: the wrappers != the plain versions on block 0")
        row["seconds"] = time.perf_counter() - t0
        rows[k] = row
        emit("shared_stream_sweep", **row)
        del sub, words, total, dw, dt, dec
    return rows


def ss_launch_shape(data, frame: bytes, knobs: dict) -> dict:
    """The inputs of the largest table-log group's D4/D5 launch at a
    point: the blocks of the input and the normalized counts the frame's
    block headers carry."""
    import numpy as np

    from entropy_coders_tpu_torch import frame as TF

    pf = TF._parse_frame(frame)
    bs, k = knobs["block_size"], knobs["k"]
    heads = [TF._read_block_header(pf.section(i))[:2]
             for i in range(pf.n_blocks)]
    Ls = np.array([L for _, L in heads])
    L = int(np.bincount(Ls).argmax())
    rows = np.flatnonzero(Ls == L)
    blocks = np.asarray(data)[: pf.n_blocks * bs].reshape(-1, bs)[rows]
    nt = np.stack([heads[i][0] for i in rows]).astype(np.int32)
    return _ss_inputs(np.ascontiguousarray(blocks), nt, k, L), len(set(Ls))


def ss_stages(T, data, knobs: dict, frame: bytes, runs: int = 3) -> dict:
    """The host's time in each ``ect.*`` stage of a compress and a
    decompress at a point (the MODE_FSE parts ``ect.compress.fse_*`` and
    ``ect.decompress.fse_*`` among them), medians of ``runs`` warm runs
    after a warm-up (``mesh_turns`` on the unsharded call alone), beside
    the runs' wall times."""
    from entropy_coders_tpu_torch import parallel as P

    t = mesh_turns(T, P, {"unsharded": None}, data, knobs, frame,
                   runs)["unsharded"]
    return {k: t[k] for k in ("compress_median_s", "decompress_median_s",
                              "stage_median_ms")}


def ss_point(T, data, name: str, lat: dict, mhz: float) -> dict:
    """One 128 MiB shared-stream point: compress and decompress, cold and
    warm, the host's time by stage (``ss_stages``), the frame's bytes and
    sha256 against the JAX package's, the launches of a round trip (D4/D5 and D3 one a table-log group a
    direction, B1/B2 and D1/D2 none, no plain core on a CUDA tensor),
    D4/D5 at the point's launch shape against the plain versions on the
    same tensors (``SS_PLAIN_BLOCKS`` of its blocks)."""
    from entropy_coders_tpu_torch import native

    knobs, want_bytes, want_sha = SHARED_STREAM[name]
    plain_on_cuda = {}
    with plain_cores_on_cuda(plain_on_cuda):
        frame, times = roundtrip(T, data, **knobs)
    check(not plain_on_cuda, f"{name}: plain cores ran on CUDA tensors "
          f"{plain_on_cuda}")
    check(len(frame) == want_bytes and _sha(frame) == want_sha,
          f"{name}: frame {len(frame)} bytes, sha256 {_sha(frame)}; the JAX "
          f"package's is {want_bytes} bytes, {want_sha}")
    inp, groups = ss_launch_shape(data, frame, knobs)
    got = times["launches"]
    want = {"decode": 0, "encode": 0, "merge": 0, "split": 0,
            "tables": 2 * groups, "fse_encode": groups, "fse_decode": groups,
            "histogram": 1, "crc": 0}
    check(got == want, f"{name}: a round trip launched {got}, expected "
          f"{want}")
    shape = ss_time_shape(inp, lat, mhz, SS_PLAIN_BLOCKS[name])
    out = {"frame_bytes": len(frame), "sha256": _sha(frame),
           "ratio": len(frame) / len(data), "knobs": knobs,
           "groups": groups, "launch_shape": shape,
           "stages": ss_stages(T, data, knobs, frame),
           "compress_peak": {"input_bytes": len(data), **compress_peak(
               lambda: T.compress(data, **knobs))},
           "compress_GBps": len(data) / times["compress_s_warm"] / 1e9,
           "decompress_GBps": len(data) / times["decompress_s_warm"] / 1e9,
           **times}
    if knobs["k"] <= 2:  # the reference format: the C++ host codec
        t0 = time.perf_counter()
        nf = native.compress(data, k=knobs["k"])
        t1 = time.perf_counter()
        back = native.decompress(nf, k=knobs["k"], max_out=len(data) + 16)
        t2 = time.perf_counter()
        check(back == data.tobytes(), f"{name}: the host codec's round trip")
        out["cpp_host"] = {"compress_s": t1 - t0, "decompress_s": t2 - t1,
                           "bytes": len(nf)}
    emit(f"shared_stream_{name}", **out)
    return out


def phase_shared_stream(T, data) -> dict:
    """The shared-stream coder on the card: D4/D5 against their plain
    versions (``ss_kernel_cases``), then both 128 MiB points
    (``ss_point``). Returns the kernels' results for the kernels line."""
    from entropy_coders_tpu_torch.tools import lane_shapes as LS

    t0 = time.perf_counter()
    cases = ss_kernel_cases()
    emit("shared_stream_kernels", **cases, seconds=time.perf_counter() - t0)
    text, lat = sass_and_latencies()
    mhz = LS.card_clocks()["sm_max_mhz"]
    points = {name: ss_point(T, data, name, lat, mhz)
              for name in SHARED_STREAM}
    inp, _ = ss_launch_shape(data, T.compress(
        data, **SHARED_STREAM["fse_default"][0]), SHARED_STREAM[
            "fse_default"][0])
    info = ss_kernel_info(text, inp["L"], inp["packed"].shape[1])
    emit("shared_stream_kernel_info", **info)
    sweep = ss_sweep(inp, lat, mhz)
    del inp
    worst = max([cases["max_abs_err"]]
                + [p["launch_shape"]["max_abs_err"] for p in points.values()]
                + [r["plain_first_block_err"] for r in sweep.values()])
    emit("shared_stream", seconds=time.perf_counter() - t0,
         max_abs_err=worst, sm_max_mhz=mhz)
    return {"points": points, "max_abs_err": worst, "sweep": sweep,
            "kernel_info": info}


def run_single(T, PL, gg, data, card):
    """The single-device phases; returns the main path's launch counts,
    B1's and B2's largest difference from their plain versions (phases
    ``kernels``, ``timing`` and ``lane_entries``), the timings at the main
    path's launch shapes (with the entries' beside them, ``entries``),
    D1-D3's largest differences (phase ``device_host`` and the timings)
    and D3's timings (``device_host.TABLE_SHAPES``)."""
    from entropy_coders_tpu_torch.ops import coder as C
    from entropy_coders_tpu_torch.ops import crc as K
    from entropy_coders_tpu_torch.ops import device_repack as DR
    from entropy_coders_tpu_torch.ops import histogram as H
    from entropy_coders_tpu_torch.ops import tables as TB

    worst = phase_kernels()
    dh_err = phase_device_host()

    # the main path: every count starts at 0 here, and only the
    # compress/decompress calls below add to it
    PL.DECODE_LAUNCHES = 0
    PL.ENCODE_LAUNCHES = 0
    DR.MERGE_LAUNCHES = 0
    DR.SPLIT_LAUNCHES = 0
    TB.TABLE_LAUNCHES = 0
    C.ENCODE_LAUNCHES = 0
    C.DECODE_LAUNCHES = 0
    H.HIST_LAUNCHES = 0
    K.CRC_LAUNCHES = 0
    plain_on_cuda = {}
    with plain_cores_on_cuda(plain_on_cuda):
        phase_goldens(T, gg)
        tp_knobs = dict(block_size=16 * MIB, k=16384, table_log=8,
                        lanes=True)
        par_knobs = dict(block_size=16 * MIB, k=8192, table_log=11,
                         lanes=True, bit_pack=True)
        _, tp_frame = phase_point(T, "throughput", data, THROUGHPUT_BYTES,
                                  **tp_knobs)
        ratio, par_frame = phase_point(T, "parity", data, PARITY_BYTES,
                                       **par_knobs)
        check(ratio <= REFERENCE_RATIO, f"parity ratio {ratio} > "
              f"{REFERENCE_RATIO}")
        ddata = default_data(gg.gen_sequence)
        dframe = phase_default(T, ddata)
    # read before any phase forces a route: these are the main path's own
    launches = _launch_counts_all()
    check(min(launches.values()) > 0,
          f"a kernel of the main path never launched: {launches}")
    check(launches["tables"] == D3_MAIN_PATH,
          f"{launches['tables']} D3 launches on the main path, expected "
          f"{D3_MAIN_PATH}")
    check(launches["fse_encode"] == launches["fse_decode"] == FSE_MAIN_PATH,
          f"{launches['fse_encode']} / {launches['fse_decode']} D4 / D5 "
          f"launches on the main path, expected {FSE_MAIN_PATH} each")
    check(launches["histogram"] == D6_MAIN_PATH,
          f"{launches['histogram']} D6 launches on the main path, expected "
          f"{D6_MAIN_PATH}")
    check(launches["crc"] == CRC_MAIN_PATH,
          f"{launches['crc']} crc launches on the main path, expected "
          f"{CRC_MAIN_PATH}")
    check(not plain_on_cuda, f"the main path ran the shared-stream or "
          f"histogram plain versions on CUDA tensors: {plain_on_cuda}")
    emit("launches", **launches, plain_cores_on_cuda=0)
    phase_routes(T, PL, {"throughput": (data, tp_knobs, tp_frame),
                         "parity": (data, par_knobs, par_frame),
                         "default": (ddata, {}, dframe)})
    phase_entry_points(T, PL, gg, data)
    phase_trace(T, {"throughput": (data, THROUGHPUT, None),
                    "default": (ddata, {}, None),
                    "throughput_cpp_repack": (data, THROUGHPUT, False),
                    "default_cpp_repack": (ddata, {}, False)})
    del ddata

    timing = phase_timing(data)
    worst = max([worst] + [timing[p][s]["max_abs_err"]
                           for p in ("throughput", "parity", "shapes")
                           for s in timing[p]])
    dh_err["tables"] = max([dh_err["tables"]]
                           + [r["max_abs_err"]
                              for r in timing["tables"].values()])
    # the JAX package's entries: a second route to B1 and B2, after the
    # main path's counts were read
    timing["entries"], entries_err = phase_lane_entries(data, card)
    worst = max(worst, entries_err)
    # the shared-stream coder (D4/D5): its kernels against their plain
    # versions and its two 128 MiB points, after the main path's counts
    timing["shared_stream"] = phase_shared_stream(T, data)
    # the root scripts' measurements: after the timed phases, so that their
    # profiler windows follow phase trace as they always have
    phase_configs(PL)
    # the root bench.py and __graft_entry__.py on the port
    phase_bench(T, gg, card)
    phase_graft()
    return launches, worst, timing, dh_err


def run_parallel(T, PL, R, data):
    """The multi-device phases (``ring``, ``sharded``, ``multihost``);
    returns B3's largest difference, its full-width timing, its peer-rank
    results (a string on one card) and the multi-device path's launch
    counts."""
    ring_err, ring_full, ring_peer = phase_ring(data)
    single = T.compress(data, device="cuda", **THROUGHPUT)
    expected = {leg: hashlib.sha256(
        single if not kw else T.compress(data, device="cuda",
                                         **THROUGHPUT, **kw)).hexdigest()
        for leg, kw in MULTIHOST_LEGS.items()}
    # the multi-device path: every count starts at 0 here, and only the
    # parallel calls of phase_sharded add to it
    PL.DECODE_LAUNCHES = 0
    PL.ENCODE_LAUNCHES = 0
    R.RING_LAUNCHES = 0
    before = _launch_counts_all()
    phase_sharded(T, data, single)
    par = {"ring": R.RING_LAUNCHES,
           **{k: v - before[k] for k, v in _launch_counts_all().items()}}
    # phase sharded writes no frame with crcs: the crc kernel may not run
    check(min(v for k, v in par.items() if k != "crc") > 0,
          f"a kernel of the multi-device path never launched: {par}")
    emit("launches_parallel", **par)
    phase_multihost(expected)
    return ring_err, ring_full, ring_peer, par


def _lane_row(name, kind, src, replaces, launches, worst, shapes):
    """B1 or B2 in the kernels line: its time, plain version and bound at
    the throughput launch shape, and every launch shape's time beside its
    bound."""
    tp = shapes["throughput"]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": worst,
            "ms": tp[kind]["ms"], "plain_ms": tp[kind]["plain_ms"],
            "bound_ms": tp[kind]["bound_ms"], "bound_by": tp[kind]["bound_by"],
            "library_ms": None,
            "launch_shape": {key: tp[key] for key in ("B", "k", "R", "L")}
            | {"threads": tp["threads"][kind]},
            "shapes": {s: {"B": r["B"], "k": r["k"], "R": r["R"], "L": r["L"],
                           "threads": r["threads"][kind],
                           "ms": r[kind]["ms"],
                           "bound_ms": r[kind]["bound_ms"],
                           "bound_by": r[kind]["bound_by"],
                           "share_of_bound": r[kind]["share_of_bound"]}
                       for s, r in shapes.items()}}


def _device_host_row(name, src, replaces, launches, shapes, pick, checked):
    """D1 or D2 in the kernels line: its wrapper's time at the throughput
    launch shape beside the bare kernel's, the plain version's, the bound
    and the C++ call's host time; every launch shape beside it. ``pick``
    takes a shape's ``device_host`` entry to the kernel's.
    ``max_abs_err`` is the largest difference measured between the kernel
    and its plain version or the C++ library, over phase ``device_host``'s
    cases (``checked``) and every launch shape."""
    tp = pick(shapes["throughput"]["device_host"])
    err = max([checked] + [pick(r["device_host"])["max_abs_err"]
                           for r in shapes.values()])
    keys = ("ms", "kernel_ms", "launcher_ms", "old_ms", "old_kernel_ms",
            "old_device_ms", "plain_ms", "cpp_ms", "bound_ms", "bytes")
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": tp["ms"], "plain_ms": tp["plain_ms"],
            "bound_ms": tp["bound_ms"], "bound_by": tp["bound_by"],
            "library_ms": None, "cpp_host_ms": tp["cpp_ms"],
            "kernel_ms": tp["kernel_ms"], "old_ms": tp.get("old_ms"),
            "kernels_a_call": {
                s: pick(r["device_host"])["device_ops"]["kernels"]
                for s, r in shapes.items()},
            "shapes": {s: {k: v for k, v in pick(r["device_host"]).items()
                           if k in keys}
                       | {"B": r["B"], "k": r["k"], "L": r["L"]}
                       for s, r in shapes.items()}}


def _tables_row(src, launches, tables, checked):
    """D3 in the kernels line: the decode half at one lane group's launch
    shape of the throughput point (8 blocks at L = 8, what the main path
    launches): a wrapper call beside the kernel alone, the empty launch's
    floor, the plain version, the byte bound and the C++ build; both
    halves at every ``device_host.TABLE_SHAPES`` shape beside it, with the
    parent's call of both halves in turns (``old_ms``) when ``build/parent``
    holds it."""
    keys = ("ms", "host_ms", "kernel_ms", "empty_ms", "empty_kernel_ms",
            "plain_ms", "cpp_ms", "bound_ms", "share_of_bound",
            "share_of_empty")
    top = tables["group_throughput"]["decode"]
    return {"name": "build_tables (D3)", "route": "cuda", "source": src,
            "replaces": "entropy_coders_tpu/ops/tables.py:44",
            "launches": launches,
            "max_abs_err": max([checked] + [r["max_abs_err"]
                                            for r in tables.values()]),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "cpp_host_ms": top["cpp_ms"],
            "kernel_ms": top["kernel_ms"], "empty_ms": top["empty_ms"],
            "empty_kernel_ms": top["empty_kernel_ms"],
            "old_ms": tables["group_throughput"].get("both", {}).get(
                "old_ms"),
            "shapes": {s: {"B": r["B"], "L": r["L"], "cluster": r["cluster"],
                           "threads": r["threads"],
                           **{h: {k: r[h][k] for k in keys}
                              for h in ("decode", "encode")},
                           "both": {k: v for k, v in r.get("both", {}).items()
                                    if not k.endswith("turns")}}
                       for s, r in tables.items()}}


def _layout_row(name, replaces, src, launches, err, one10, lay10, turns,
                timed):
    """B4 or B5 in the kernels line: layout ``timed`` against its plain
    version on one 16 MiB block at L=10; every layout's ms on all eight
    blocks (``layouts``) and, with ``build/parent``, in turns with the
    parent's kernel (``old_ms``)."""
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            **one10[timed], "library_ms": None,
            "old_ms": (turns or {}).get(timed, {}).get("old_ms"),
            "layouts": {n: r["ms"] for n, r in lay10.items()},
            "layouts_in_turns": {n: {k: v for k, v in r.items()
                                     if not k.endswith("turns")}
                                 for n, r in (turns or {}).items()}}


def _shared_stream_row(name, kind, replaces, launches, ss):
    """D4 or D5 in the kernels line: its launcher at the MODE_FSE default
    point's launch shape (1,024 blocks of 128 KiB, k = 1024, L = 11), the
    plain version on the same CUDA tensors there, and the k = 2 point's
    shape beside (its plain version on the first two blocks at all 65,535
    rounds, the kernel's time there beside it, ``plain_k2``); the C++
    host codec on the k = 2 point's whole input (the reference format,
    one stream)."""
    pts = ss["points"]
    top = pts["fse_default"]["launch_shape"]
    k2 = pts["fse_k2"]["launch_shape"]["plain"]
    keys = ("ms", "wrapper_ms", "bytes_ms", "chain_ms", "bound_ms",
            "bound_by", "binds", "share_of_bound", "GBps", "launch")
    return {"name": name, "route": "cuda",
            "source": "entropy_coders_tpu_torch/csrc/fse_coder.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": ss["max_abs_err"], "ms": top[kind]["ms"],
            "plain_ms": top["plain"][kind]["plain_ms"],
            "bound_ms": top[kind]["bound_ms"],
            "bound_by": top[kind]["bound_by"], "library_ms": None,
            "plain_k2": {"B": k2["B"], "k": k2["k"], "L": k2["L"],
                         "R": k2["R"], **k2[kind]},
            "cpp_host_s": pts["fse_k2"]["cpp_host"][
                "compress_s" if kind == "encode" else "decompress_s"],
            "shapes": {p: {"B": r["launch_shape"]["B"],
                           "k": r["launch_shape"]["k"],
                           "L": r["launch_shape"]["L"],
                           "R": r["launch_shape"]["R"],
                           **{key: r["launch_shape"][kind][key]
                              for key in keys},
                           "parent_in_turns": (r["launch_shape"]["in_turns"]
                                               or {}).get(kind)}
                       for p, r in pts.items()},
            "sweep": {k: {f"kernel{path}": r[f"kernel{path}"][kind]["ms"]
                          for path in (0, 1, 2)
                          if kind in r.get(f"kernel{path}", {})}
                      for k, r in ss["sweep"].items()}}


def _histogram_row(src, launches, hist, checked):
    """D6 in the kernels line: a wrapper call at the throughput launch
    shape (8 blocks of 16 MiB, one compress's) beside the kernel alone,
    the plain version (the offset ``bincount`` route on the same CUDA
    tensor, also ``library_ms``: the one PyTorch call that computes the
    same function) and the byte bound; every ``device_host.HIST_SHAPES``
    shape beside it, the kernel alone on each byte pattern at the
    throughput shape.
    ``max_abs_err`` is the largest difference from the plain version over
    phase ``device_host``'s cases (``checked``) and every shape."""
    from entropy_coders_tpu_torch.tools import device_host as DH

    keys = ("B", "n", "slices", "grid", "ms", "kernel_ms", "host_ms",
            "plain_ms", "bound_ms", "share_of_bound")
    shapes = {s: r for s, r in hist.items() if s in DH.HIST_SHAPES}
    tp = shapes["throughput"]
    return {"name": "histogram (D6)", "route": "cuda", "source": src,
            "replaces": "entropy_coders_tpu/ops/histogram.py:36",
            "launches": launches,
            "max_abs_err": max([checked] + [r["max_abs_err"]
                                            for r in shapes.values()]),
            "ms": tp["ms"], "plain_ms": tp["plain_ms"],
            "bound_ms": tp["bound_ms"], "bound_by": "bytes",
            "library_ms": tp["library_ms"], "kernel_ms": tp["kernel_ms"],
            "shapes": {s: {k: r[k] for k in keys}
                       for s, r in shapes.items()},
            "patterns_kernel_ms": hist["patterns"]}


def _crc_row(src, launches, crc, checked):
    """The crc kernel in the kernels line: a wrapper call at the parity
    cell's compress shape (8 blocks of 16 MiB) beside its two kernels
    alone, the plain version on the same CUDA tensors, ``zlib.crc32`` on
    the host (the pass it replaces) and the byte bound; every
    ``device_host.CRC_SHAPES`` shape beside it. ``max_abs_err`` counts the
    rows that differ from ``zlib.crc32`` over phase ``device_host``'s cases
    (``checked``)."""
    keys = ("B", "n1", "n2", "units", "grid", "ms", "kernel_ms",
            "chunks_ms", "host_ms", "plain_ms", "zlib_ms", "bound_ms",
            "share_of_bound")
    top = crc["parity_compress"]
    return {"name": "crc32", "route": "cuda", "source": src,
            "replaces": None, "launches": launches, "max_abs_err": checked,
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "zlib_host_ms": top["zlib_ms"],
            "kernel_ms": top["kernel_ms"],
            "shapes": {s: {k: r[k] for k in keys} for s, r in crc.items()}}


def print_kernels(launches, worst, timing, dh_err, ring_err, ring_full,
                  ring_peer, par, layouts):
    """The line before the last: every kernel with its main-path launches,
    its largest difference from its plain version, its times and its
    bound. B1 and B2 are timed at the throughput launch shape (B=4 blocks
    of 16 MiB), each launch shape beside it, B1 also in turns with the
    parent's (``old_ms``, with ``build/parent``); ``entries`` gives, at
    each launch shape, the JAX package's entry that reaches the kernel
    (``decode_lanes`` / ``encode_lanes``, host numpy in) beside the
    wrapper call on device-resident inputs. B3 at n=8 virtual ranks,
    its bound the function's bytes, (n + n*n) * chunk; its ``library_ms``
    is NCCL's ``all_gather_into_tensor`` across the cards of the peer
    full-width case, by the slowest rank's CUDA events, with its host clock
    and the peer B3's device and host times and NVLink bound beside it,
    and null on one card (NCCL needs a rank a card). B4 and B5 are one
    kernel (``pl_decode_layout.cu``, B1's own through
    ``lane_decode.cuh``): B4's row counts the layouts that
    ``tools/l10_attack.py`` defines (fused, nosym) and times fused, B5's
    the layouts the harness serves (flat, split, upack) and times split,
    each against its plain version on one 16 MiB block at L=10;
    ``layouts`` gives every layout's ms on all eight blocks at L=10. D1
    and D2 (``tools.device_host``) are timed through their wrappers at the
    throughput launch shape, the C++ call of the port's host library
    beside them, their two kernels' device time (``kernel_ms``, from the
    profiler), the first design's call (``old_ms``, when ``build/parent``
    holds it) and the kernels a call issued. D3 is timed at a lane group's
    launch shape (``_tables_row``), D4 and D5 at the MODE_FSE default
    point's (``_shared_stream_row``), D6 at the throughput point's
    (``_histogram_row``; its ``library_ms`` is the ``bincount`` route). No
    PyTorch call computes B1, B2, B4, B5 or D1-D5."""
    lay_launches, lay_err, lay10, one10, turns = layouts
    shapes = timing["shapes"]
    src = "entropy_coders_tpu_torch/csrc"
    b1 = _lane_row("pl_decode (B1)", "decode", f"{src}/pl_decode.cu",
                   "entropy_coders_tpu/ops/pl_coder.py:285",
                   launches["decode"], worst, shapes)
    b1["old_ms"] = shapes["throughput"]["decode"].get("old_ms")
    b1["sass_vs_parent"] = timing.get("b1_sass_diff")
    b2 = _lane_row("pl_encode (B2)", "encode", f"{src}/pl_encode.cu",
                   "entropy_coders_tpu/ops/pl_coder.py:1075",
                   launches["encode"], worst, shapes)
    for row, kind in ((b1, "decode"), (b2, "encode")):
        row["entries"] = {s: r[kind] for s, r in timing["entries"].items()}
    print(json.dumps({"kernels": [
        b1,
        b2,
        {"name": "ring_all_gather (B3)", "route": "cuda",
         "source": f"{src}/ring.cu",
         "replaces": "entropy_coders_tpu/parallel/rdma.py:46",
         "launches": par["ring"], "max_abs_err": ring_err,
         "ms": ring_full["ms"], "plain_ms": ring_full["plain_ms"],
         "bound_ms": ring_full["bound_ms"], "bound_by": "bytes",
         "kernel_ms": ring_full["window"]["kernel_ms"],
         "queued_ms": ring_full["queued_ms"],
         **_ring_library(ring_peer)},
        _layout_row("pl_decode_layout fused/nosym (B4)",
                    "tools/l10_attack.py:94", f"{src}/pl_decode_layout.cu",
                    lay_launches["fused"] + lay_launches["nosym"], lay_err,
                    one10, lay10, turns, "fused"),
        _layout_row("pl_decode_layout flat/split/upack (B5)",
                    "tools/l10_attack_harness.py:24",
                    f"{src}/pl_decode_layout.cu",
                    sum(lay_launches[n] for n in ("flat", "split", "upack")),
                    lay_err, one10, lay10, turns, "split"),
        _device_host_row("lane_merge (D1)", f"{src}/repack.cu",
                         "entropy_coders_tpu/ops/device_repack.py:56",
                         launches["merge"], shapes,
                         lambda d: d["repack"]["merge"], dh_err["repack"]),
        _device_host_row("lane_split (D2)", f"{src}/repack.cu",
                         "entropy_coders_tpu/ops/device_repack.py:79",
                         launches["split"], shapes,
                         lambda d: d["repack"]["split"], dh_err["repack"]),
        _tables_row(f"{src}/tables.cu", launches["tables"], timing["tables"],
                    dh_err["tables"]),
        _shared_stream_row("fse_encode (D4)", "encode",
                           "entropy_coders_tpu/ops/coder.py:62",
                           launches["fse_encode"], timing["shared_stream"]),
        _shared_stream_row("fse_decode (D5)", "decode",
                           "entropy_coders_tpu/ops/coder.py:166",
                           launches["fse_decode"], timing["shared_stream"]),
        _histogram_row(f"{src}/histogram.cu", launches["histogram"],
                       timing["histogram"], dh_err["histogram"]),
        _crc_row(f"{src}/crc32.cu", launches["crc"], timing["crc"],
                 dh_err["crc"]),
    ]}), flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import entropy_coders_tpu_torch as T
        from entropy_coders_tpu_torch.ops import pl_coder as PL
        from entropy_coders_tpu_torch.parallel import rdma as R
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--multihost-worker"]:
        return multihost_worker(*map(int, sys.argv[2:5]))
    if sys.argv[1:2] == ["--nccl-worker"]:
        return nccl_worker(*map(int, sys.argv[2:7]))
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    try:
        card = phase_env()
        gg = load_testdata()
        data = gg.gen_sequence(0.2, BENCH_SIZE, BENCH_SEED)
        run_all(T, PL, R, gg, data, card)
    except Exception:  # report any failing phase, print no result
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_all(T, PL, R, gg, data, card):
    """Every phase, then the kernels line."""
    launches, worst, timing, dh_err = run_single(T, PL, gg, data, card)
    layouts = phase_layouts(data)
    ring_err, ring_full, ring_peer, par = run_parallel(T, PL, R, data)
    print_kernels(launches, worst, timing, dh_err, ring_err, ring_full,
                  ring_peer, par, layouts)


if __name__ == "__main__":
    sys.exit(main())

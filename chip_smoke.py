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
tables with -1 counts, 512 tables, equal rows). The main path's D3
launches are checked exactly: one a lane group a direction, 2 / 2 / 3 a
round trip at the throughput / parity / default points and 27 with the
goldens. Phase ``routes``
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
two kernels and no memset or fill. When ``build/parent`` holds a checkout
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
and with the C++ repack. Phase ``configs`` (after ``lane_entries``)
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
* ``sharded``: the throughput point through ``compress`` without a
  sharding, ``parallel.compress`` / ``decompress`` on eight virtual ranks
  and on ``default_mesh()``, in turns (a warm-up round, then three, the
  order reversed every other round; medians), and 5 blocks over 8 ranks:
  each frame equals ``compress``'s, byte for byte, and round-trips; with
  ``shared_table=True`` the sharded histogram, the ring's all-reduce of
  the per-rank counts and ``np.bincount`` agree, and the header they
  normalise to is the one the frame carries. With two cards or more,
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
import hashlib
import importlib.util
import json
import socket
import statistics
import subprocess
import sys
import time
import traceback
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
    port's C++ host library, exactly (``tools.device_host``). Returns the
    largest difference measured, of the repack and of the tables."""
    from entropy_coders_tpu_torch.tools import device_host as DH

    t0 = time.perf_counter()
    repack = DH.check_repack()
    tables = DH.check_tables()
    emit("device_host", repack=repack, tables=tables,
         seconds=time.perf_counter() - t0)
    return {"repack": repack["max_abs_err"], "tables": tables["max_abs_err"]}


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
    """The launch counts of B1, B2 and D1-D3 as they stand."""
    from entropy_coders_tpu_torch.ops import pl_coder as PL

    return {"decode": PL.DECODE_LAUNCHES, "encode": PL.ENCODE_LAUNCHES,
            **_device_host_counts()}


def roundtrip(T, data, **kw):
    """compress + decompress twice each (cold, then warm); the round trip
    is asserted. Returns (frame, timings); the timings carry every
    kernel's launches of one compress + decompress."""
    import torch

    times = {}
    c0 = _launch_counts_all()
    for tag in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = T.compress(data, device="cuda", **kw)
        times[f"compress_s_{tag}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = T.decompress(frame, device="cuda")
        torch.cuda.synchronize()
        times[f"decompress_s_{tag}"] = time.perf_counter() - t0
        check(out == data.tobytes(), f"round trip failed ({kw})")
    times["launches"] = {k: (v - c0[k]) // 2
                         for k, v in _launch_counts_all().items()}
    return frame, times


# D3 launches a 128 MiB round trip: one a lane group a direction (the
# default point's uniform block is a table-log group of its own on compress,
# then stored RAW); with the five golden frames' 13, the main path's 27
D3_LAUNCHES = {"throughput": 2, "parity": 2, "default": 3}
D3_MAIN_PATH = 13 + 2 * sum(D3_LAUNCHES.values())


def check_d3_launches(name, launches):
    check(launches["tables"] == D3_LAUNCHES[name],
          f"{name}: {launches['tables']} D3 launches a round trip, "
          f"expected {D3_LAUNCHES[name]} (one a lane group a direction)")


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
    ``ect.*`` ranges, clocked here; ``ect.tables`` lies inside the dispatch
    stages); every frame equal to the expected one and every round trip
    exact; a route's launch counts must show its kernels and none of the
    others'."""
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
    ``ect.tables`` lies inside the dispatch stages). The traces go to
    ``build/trace/``."""
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
            device_time_visible=bool(ops),
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
    for i, (_, lo, hi) in enumerate(_shares(blocks_dev.shape[0], (None,) * n)):
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


def mesh_turns(T, P, meshes, data, knobs, want, runs: int = 3) -> dict:
    """compress + decompress of ``data`` on each mesh of ``meshes`` (name
    -> mesh, None for no sharding), one warm-up round, then ``runs``
    rounds in turns, the order reversed every other round (ABC, CBA, ...).
    Host clock, every card synchronised before and after each call, and
    the host's time in each ``ect.*`` stage (``stage_clocks``); every
    frame must equal ``want`` and every round trip be exact. Medians,
    every run and the warm-up round (``*_s_cold``), in seconds; GB/s of
    raw input at the medians."""
    names = list(meshes)
    times = {n: {"compress_s": [], "decompress_s": [], "stages": []}
             for n in names}
    order, spent = [], {}
    with stage_clocks(spent):
        for r in range(runs + 1):
            for name in (names if r % 2 else names[::-1]):
                comp, decomp = _codec(T, P, meshes[name])
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
        t["ranks"] = 1 if meshes[name] is None else len(meshes[name])
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


def mesh_cards(T, P, data, knobs, runs: int = 3) -> dict:
    """One card (``default_mesh(1)``) against every card
    (``default_mesh()``) on ``data``: in turns (``mesh_turns``, every
    frame equal to the unsharded one-card frame), then each mesh's
    compress and decompress once under the profiler (``device_overlap``),
    their frames and round trip checked."""
    want = T.compress(data, device="cuda", **knobs)
    meshes = {"one_card": P.default_mesh(1), "all_cards": P.default_mesh()}
    out = {"knobs": knobs, **mesh_turns(T, P, meshes, data, knobs, want,
                                        runs)}
    for name, mesh in meshes.items():
        frames, backs = [], []
        c = device_overlap(
            lambda: frames.append(P.compress(data, mesh, **knobs)))
        d = device_overlap(lambda: backs.append(P.decompress(want, mesh)))
        check(all(f == want for f in frames),
              f"overlap: the frame on {name} differs")
        check(all(_same_bytes(b, data) for b in backs),
              f"overlap: round trip on {name}")
        out[name]["overlap"] = {"compress": c, "decompress": d}
    return out


def phase_sharded(T, data, single_frame):
    """The throughput point through parallel.compress/decompress; the
    unsharded call, eight virtual ranks and ``default_mesh()`` in turns;
    with two cards or more, one card against all of them at 128 MiB and at
    1 GiB in config 4's shape (BASELINE.md: shared table, 4 MiB blocks,
    k=8192, the default table-log policy), each with the cards' device
    windows."""
    import numpy as np
    import torch

    from entropy_coders_tpu_torch import frame as TF
    from entropy_coders_tpu_torch import parallel as P
    from entropy_coders_tpu_torch.parallel import rdma as R

    dev = torch.device("cuda", 0)
    virtual8 = (dev,) * 8
    turns = mesh_turns(T, P, {"unsharded": None, "virtual_8": virtual8,
                              "default_mesh": P.default_mesh()},
                       data, THROUGHPUT, single_frame)
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
    emit("sharded", meshes=turns, five_blocks_bytes=len(frame5),
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


def run_single(T, PL, gg, data, card):
    """The single-device phases; returns the main path's launch counts,
    B1's and B2's largest difference from their plain versions (phases
    ``kernels``, ``timing`` and ``lane_entries``), the timings at the main
    path's launch shapes (with the entries' beside them, ``entries``),
    D1-D3's largest differences (phase ``device_host`` and the timings)
    and D3's timings (``device_host.TABLE_SHAPES``)."""
    from entropy_coders_tpu_torch.ops import device_repack as DR
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
    phase_goldens(T, gg)
    tp_knobs = dict(block_size=16 * MIB, k=16384, table_log=8, lanes=True)
    par_knobs = dict(block_size=16 * MIB, k=8192, table_log=11, lanes=True,
                     bit_pack=True)
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
    emit("launches", **launches)
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
    before = _device_host_counts()
    phase_sharded(T, data, single)
    par = {"decode": PL.DECODE_LAUNCHES, "encode": PL.ENCODE_LAUNCHES,
           "ring": R.RING_LAUNCHES,
           **{k: v - before[k] for k, v in _device_host_counts().items()}}
    check(min(par.values()) > 0,
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
    launch shape (``_tables_row``). No PyTorch call computes B1, B2, B4,
    B5 or D1-D3."""
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

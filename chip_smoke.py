"""On-card check of the PyTorch + CUDA port (``entropy_coders_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``entropy_coders_tpu_torch/csrc``, holds
each one against its plain PyTorch version on the card, then drives the
port's ``compress``/``decompress`` on ``device="cuda"`` through every golden
container frame and three 128 MiB operating points, and times the kernels.
Each phase prints one JSON line. The line before the last lists the
kernels; the last line is ``{"ok": true, "device": {...}}``, printed only
when every phase passed. Any failure exits non-zero without it, as does a
machine without CUDA or a directory without the repository.

Test data comes from ``tests/data/generate_golden.py`` (jax-free). Nothing
of JAX is imported.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
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


def cuda_ms(fn, runs: int = 7, warmup: int = 2):
    """Median device time of ``fn`` in ms over ``runs`` runs after
    ``warmup``, each bracketed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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

    from entropy_coders_tpu import native
    from entropy_coders_tpu_torch.kernels import build as KB

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)  # the card's name and power limit, as-is
    t0 = time.perf_counter()
    KB.load()
    load_s = time.perf_counter() - t0
    print(KB.last_build["log"], file=sys.stderr, flush=True)
    check(native.available(), "native host library unavailable")
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         kernel_build_s=KB.last_build["seconds"], kernel_load_s=load_s,
         native=True)
    return card


def _case_blocks(rng, B, n, alphabet):
    import numpy as np

    if alphabet == "geo":  # geometric: a dominant symbol, count > 256
        return (rng.geometric(0.2, (B, n)) - 1).clip(0, 255).astype(np.uint8)
    return rng.integers(0, alphabet, (B, n)).astype(np.uint8)


def compare_lanes(blocks_np, L, k, device="cuda", time_kernels=False,
                  time_plain=False):
    """Encode and decode ``blocks_np`` (B, (R+1)k) with the kernels and the
    plain versions on the same CUDA tensors; return the largest output
    difference and, when asked, the kernels' and plain versions' median
    times in ms."""
    import numpy as np
    import torch

    from entropy_coders_tpu.normalize import normalize_batch
    from entropy_coders_tpu_torch.ops import pl_coder as PL

    B, n = blocks_np.shape
    R = n // k - 1
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks_np])
    nt, l2 = normalize_batch(counts, n, L)
    check((l2 == L).all(), f"table log raised to {l2} (L={L})")
    W = PL.encode_w_bound(R, L)
    tabs = PL.tables_from_norm(nt, L, device)
    blocks = torch.from_numpy(blocks_np).to(device)

    words, sizes = PL.encode_lanes(blocks, tabs, k=k, L=L, W=W)
    rwords, rsizes = PL.encode_lanes_ref(blocks, tabs, k=k, L=L, W=W)
    syms, finals, cur = PL.decode_lanes(words, sizes, tabs.dec, L=L, R=R)
    rsyms, rfinals, rcur = PL.decode_lanes_ref(words, sizes, tabs.dec, L=L,
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
            lambda: PL.encode_lanes(blocks, tabs, k=k, L=L, W=W))
        out["decode_ms"], _ = cuda_ms(
            lambda: PL.decode_lanes(words, sizes, tabs.dec, L=L, R=R))
        out["encode_GBps"] = n * B / out["encode_ms"] / 1e6
        out["decode_GBps"] = n * B / out["decode_ms"] / 1e6
    if time_plain:
        out["encode_plain_ms"], _ = cuda_ms(
            lambda: PL.encode_lanes_ref(blocks, tabs, k=k, L=L, W=W),
            runs=3, warmup=1)
        out["decode_plain_ms"], _ = cuda_ms(
            lambda: PL.decode_lanes_ref(words, sizes, tabs.dec, L=L, R=R),
            runs=3, warmup=1)
    return out


def phase_kernels():
    import numpy as np
    import torch

    from entropy_coders_tpu.normalize import normalize_batch
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


def roundtrip(T, data, **kw):
    """compress + decompress twice each (cold, then warm); the round trip
    is asserted. Returns (frame, timings)."""
    import torch

    times = {}
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
    return frame, times


def phase_point(T, name, data, expect_bytes, **kw):
    frame, times = roundtrip(T, data, **kw)
    check(len(frame) == expect_bytes,
          f"{name}: frame is {len(frame)} bytes, expected {expect_bytes}")
    ratio = len(frame) / len(data)
    emit(name, frame_bytes=len(frame), ratio=ratio, input_bytes=len(data),
         knobs={k: v for k, v in kw.items()},
         compress_GBps=len(data) / times["compress_s_warm"] / 1e9,
         decompress_GBps=len(data) / times["decompress_s_warm"] / 1e9,
         **times)
    return ratio


def phase_default(T, gen_sequence):
    """128 MiB at the library defaults (128 KiB blocks, k=1024, the
    ("fast", 0.0025) policy), with a constant block (RLE), a uniform
    block (RAW) and a 777-byte ragged tail (shared-stream MODE_FSE)."""
    import numpy as np

    from entropy_coders_tpu_torch import frame as TF

    data = gen_sequence(0.2, BENCH_SIZE + 777, BENCH_SEED + 1)
    bs = TF.DEFAULT_BLOCK_SIZE
    data[3 * bs: 4 * bs] = 7
    data[5 * bs: 6 * bs] = np.random.default_rng(5).integers(
        0, 256, bs, dtype=np.uint8)
    frame, times = roundtrip(T, data)
    pf = TF._parse_frame(frame)
    modes = {name: int((pf.modes == m).sum()) for name, m in
             (("fse_pl", TF.MODE_FSE_PL), ("fse", TF.MODE_FSE),
              ("raw", TF.MODE_RAW), ("rle", TF.MODE_RLE))}
    check(min(modes.values()) >= 1,
          f"default point missed a block mode: {modes}")
    emit("default", frame_bytes=len(frame), ratio=len(frame) / len(data),
         input_bytes=len(data), modes=modes, block_size=bs, k=TF.DEFAULT_K,
         **times)


def phase_timing(data):
    """Kernel vs plain-version times on device-resident tensors at the two
    operating points: all eight 16 MiB blocks (kernels only) and one 16 MiB
    block (kernels and plain versions, same inputs, outputs compared)."""
    block = 16 * MIB
    blocks = data.reshape(-1, block)
    out = {}
    for name, L, k in (("throughput", 8, 16384), ("parity", 11, 8192)):
        one = compare_lanes(blocks[:1], L, k, time_kernels=True,
                            time_plain=True)
        full = compare_lanes(blocks, L, k, time_kernels=True)
        out[name] = {"one_block": one, "all_blocks": full}
        emit(f"timing_{name}", one_block=one, all_blocks=full)
    return out


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
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    try:
        phase_env()
        worst = phase_kernels()
        gg = load_testdata()
        data = gg.gen_sequence(0.2, BENCH_SIZE, BENCH_SEED)

        # the main path: every count starts at 0 here, and only the
        # compress/decompress calls below add to it
        PL.DECODE_LAUNCHES = 0
        PL.ENCODE_LAUNCHES = 0
        phase_goldens(T, gg)
        phase_point(T, "throughput", data, THROUGHPUT_BYTES,
                    block_size=16 * MIB, k=16384, table_log=8, lanes=True)
        ratio = phase_point(T, "parity", data, PARITY_BYTES,
                            block_size=16 * MIB, k=8192, table_log=11,
                            lanes=True, bit_pack=True)
        check(ratio <= REFERENCE_RATIO, f"parity ratio {ratio} > "
              f"{REFERENCE_RATIO}")
        phase_default(T, gg.gen_sequence)
        launches = {"decode": PL.DECODE_LAUNCHES,
                    "encode": PL.ENCODE_LAUNCHES}
        check(launches["decode"] > 0 and launches["encode"] > 0,
              f"a kernel of the main path never launched: {launches}")
        emit("launches", **launches)

        timing = phase_timing(data)
        worst = max([worst] + [timing[p][s]["max_abs_err"]
                               for p in timing for s in timing[p]])
        one = timing["throughput"]["one_block"]
        src = "entropy_coders_tpu_torch/csrc"
        print(json.dumps({"kernels": [
            {"name": "pl_decode (B1)", "route": "cuda",
             "source": f"{src}/pl_decode.cu",
             "replaces": "entropy_coders_tpu/ops/pl_coder.py:285",
             "launches": launches["decode"], "max_abs_err": worst,
             "ms": one["decode_ms"], "plain_ms": one["decode_plain_ms"]},
            {"name": "pl_encode (B2)", "route": "cuda",
             "source": f"{src}/pl_encode.cu",
             "replaces": "entropy_coders_tpu/ops/pl_coder.py:1075",
             "launches": launches["encode"], "max_abs_err": worst,
             "ms": one["encode_ms"], "plain_ms": one["encode_plain_ms"]},
        ]}), flush=True)
    except Exception:  # report any failing phase, print no result
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

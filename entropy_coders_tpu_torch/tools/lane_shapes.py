"""B1 and B2 at the main path's launch shapes, beside their bounds.

The per-lane container launches each kernel once per ~64 MiB chunk
(``frame.py`` ``_CHUNK_BYTES``), so a launch holds one of three shapes:

  throughput  B=4 blocks of 16 MiB, k=16384, R=1023, L=8
  parity      B=4 blocks of 16 MiB, k=8192,  R=2047, L=11
  default     B=512 blocks of 128 KiB, k=1024, R=127, L = the table log the
              default policy ``("fast", 0.0025)`` picks for most blocks

A caller who asks for a larger table log gets the same B, k and R at that L
(``HIGH_SHAPES``: L = 13 and 15 at the throughput shape, 13 at the
default's).

``shape_inputs`` builds one launch's inputs from the bench corpus on the
card. ``bound`` is the least time of a kernel's work there, from three
limits, none of which depends on how fast the kernel runs:

  bytes       each input read once, each output written once (for B1 only
              the stream words the lanes hold), over 3.35 TB/s;
  operations  the instructions one warp issues a round, counted from the
              kernel's SASS (``cuobjdump -sass``, the unrolled tile of 32
              rounds) and split by pipe, over each pipe's rate (``PIPES``)
              on every SM at the maximum SM clock; the busiest pipe binds;
  chain       R x the cycles of one round's dependent path: the longest
              chain of register dependences through the tile's SASS, each
              instruction taking its latency as ``latencies`` measures it
              on the card (``csrc/latency.cu``), at the maximum SM clock.

``bound_ms`` is the larger of bytes and operations (what the kernels line
of ``chip_smoke.py`` reports); the chain is a third floor, beside it.

Run on a machine with a CUDA device:

    python -m entropy_coders_tpu_torch.tools.lane_shapes [--old DIR]
        [--rounds N] [--sass DIR] [--sweep]

prints one JSON line per shape: the kernels' times (CUDA events, median),
their bounds and the share of each, and the CTA size each launch takes.
``--old DIR`` names a checkout of another commit of this repository (e.g.
``git archive <commit> | tar -x -C DIR``) whose launchers take no CTA size
(the first design's): its ``entropy_coders_tpu_torch/csrc/`` files
``pl_encode.cu`` and ``pl_decode.cu`` are built into a library of their
own and timed against the current kernels in turns (old, new, new, old;
``--rounds`` times), their outputs compared
exactly (an old B2 gets its words zero-filled first, as its wrapper did,
and that memset is in its time). ``--sweep`` adds ``HIGH_SHAPES`` and times
the current kernels at every CTA size they are built for (``THREADS``).
``--sass DIR`` writes ``cuobjdump -sass`` of the libraries there.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..normalize import normalize_batch
from ..ops import pl_coder as PL
from .bench_data import cuda_ms, gen_sequence

MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12   # one H100 SXM's published peak
# warp instructions an SM completes a clock, by pipe (Hopper): four
# schedulers issue one each; the integer ALU and the FMA pipe (which runs
# IMAD) are 16 lanes a scheduler; a load or store through shared memory or
# L1 takes at least one cycle of the SM's 128-byte-a-clock data path
PIPES = {"issue": 4.0, "alu": 2.0, "fma": 2.0, "lsu": 1.0}
THREADS = (128, 256, 512)  # the CTA sizes the launchers are built for
DEFAULT_POLICY = ("fast", 0.0025)
REPS = 10  # launches a timed run queues back to back (``cuda_ms``'s reps)
SHAPES = {
    "throughput": dict(B=4, block=16 * MIB, k=16384, L=8),
    "parity": dict(B=4, block=16 * MIB, k=8192, L=11),
    "default": dict(B=512, block=128 << 10, k=1024, L=None),
}
HIGH_SHAPES = {
    "throughput_L13": dict(B=4, block=16 * MIB, k=16384, L=13),
    "throughput_L15": dict(B=4, block=16 * MIB, k=16384, L=15),
    "default_L13": dict(B=512, block=128 << 10, k=1024, L=13),
}


class ShapeInputs(NamedTuple):
    """One launch's inputs on the card (B2's blocks and tables, B1's words
    and sizes from B2's output)."""
    name: str
    blocks: torch.Tensor      # (B, (R+1)*k) uint8
    tabs: PL.LaneTables
    words: torch.Tensor       # (B, W, k) uint32
    sizes: torch.Tensor       # (B, k) int32
    B: int
    k: int
    L: int
    R: int
    W: int


def default_log(data: np.ndarray, block: int) -> int:
    """The table log the default policy picks for most blocks of ``data``."""
    blocks = data[: len(data) // block * block].reshape(-1, block)
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks])
    _, logs = normalize_batch(counts, block, DEFAULT_POLICY)
    vals, n = np.unique(logs, return_counts=True)
    return int(vals[np.argmax(n)])


def shape_inputs(name: str, data: np.ndarray, device="cuda") -> ShapeInputs:
    """The ``name`` launch's inputs from the first B blocks of ``data``."""
    s = {**SHAPES, **HIGH_SHAPES}[name]
    L = s["L"] if s["L"] is not None else default_log(data, s["block"])
    return launch_inputs(name, s["B"], s["block"], s["k"], L, data, device)


def launch_inputs(name: str, B: int, block: int, k: int, L: int,
                  data: np.ndarray, device="cuda") -> ShapeInputs:
    """One launch's inputs: B blocks of ``block`` bytes from ``data`` (cycled
    when it is shorter), k lanes, table log L."""
    blocks_np = np.resize(data, B * block).reshape(B, block)
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks_np])
    nt, logs = normalize_batch(counts, block, L)
    if not (logs == L).all():
        raise ValueError(f"{name}: table log raised above {L}")
    R = block // k - 1
    W = PL.encode_w_bound(R, L)
    tabs = PL.tables_from_norm(nt, L, device)
    blocks = torch.from_numpy(blocks_np).to(device)
    words, sizes = PL.encode_lanes(blocks, tabs, k=k, L=L, W=W)
    return ShapeInputs(name, blocks, tabs, words, sizes, B, k, L, R, W)


def card_clocks() -> dict:
    """The SM clock now and its maximum, MHz, as ``nvidia-smi`` reads them
    (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    sm, sm_max = (float(x) for x in out.split(","))
    return {"sm_mhz": sm, "sm_max_mhz": sm_max}


def bound(kind: str, *, B: int, k: int, L: int, R: int, W: int, sizes,
          stats: dict, sm_max_mhz: float, n_sm: int) -> dict:
    """The least time of one ``kind`` launch ("decode" or "encode") of B
    blocks of k lanes, R rounds at table log L (W word rows; ``sizes`` the
    (B, k) lane sizes in bits, which set the stream words B1 must read),
    from the kernel's ``round_stats`` ``stats``, on ``n_sm`` SMs at
    ``sm_max_mhz``: bytes over HBM_BYTES_PER_S, each pipe's instructions
    over its rate, and the chain. ``bound_ms`` is the larger of bytes and
    the busiest pipe ("operations"); ``binds`` names the largest of the
    three."""
    lanes = B * k
    tables = B * (1 << L)
    if kind == "decode":
        stream_words = int(((sizes.to(torch.int64) + 31) // 32).sum())
        nbytes = (4 * stream_words + 4 * lanes + 4 * tables   # words, sizes, table
                  + lanes * R + lanes + 4 * lanes)            # syms, finals, cursors
    else:
        nbytes = (lanes * (R + 1) + B * 256 * 8 + 2 * tables  # blocks, tables
                  + 4 * lanes * W + 4 * lanes)                # words, sizes
    clock_hz = sm_max_mhz * 1e6
    warp_rounds = lanes // 32 * R
    per = stats["per_round"]
    pipe_ms = {p: per[p] / rate * warp_rounds / (n_sm * clock_hz) * 1e3
               for p, rate in PIPES.items()}
    pipe = max(pipe_ms, key=pipe_ms.get)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = pipe_ms[pipe]
    chain_ms = R * stats["chain_cycles"] / clock_hz * 1e3
    three = {"bytes": bytes_ms, "operations": ops_ms, "chain": chain_ms}
    return {"bytes": nbytes, "int_ops": (per["alu"] + per["fma"]) * lanes * R,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "pipe_ms": pipe_ms,
            "pipe": pipe, "chain_ms": chain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "binds": max(three, key=three.get),
            "bound3_ms": max(three.values())}


def shape_bound(kind: str, inp: ShapeInputs, stats: dict,
                sm_max_mhz: float) -> dict:
    """``bound`` of one launch on ``inp``, on the card it lies on."""
    n_sm = torch.cuda.get_device_properties(
        inp.blocks.device).multi_processor_count
    return bound(kind, B=inp.B, k=inp.k, L=inp.L, R=inp.R, W=inp.W,
                 sizes=inp.sizes, stats=stats, sm_max_mhz=sm_max_mhz,
                 n_sm=n_sm)


def alone_ns(kind: str, L: int, device="cuda", R: int = 8191) -> float:
    """ns one round takes when nothing else runs: one block of 128 lanes
    (one CTA of 128 threads, one warp a scheduler), R rounds. What the
    kernel's chain takes in practice, beside its floor from the SASS."""
    rng = np.random.default_rng(L)
    k = 128
    blocks_np = (rng.geometric(0.25, (1, (R + 1) * k)) - 1).clip(0, 255).astype(np.uint8)
    counts = np.bincount(blocks_np[0], minlength=256)[None]
    nt, _ = normalize_batch(counts, blocks_np.shape[1], L)
    W = PL.encode_w_bound(R, L)
    tabs = PL.tables_from_norm(nt, L, device)
    blocks = torch.from_numpy(blocks_np).to(device)
    words, sizes = PL.encode_lanes(blocks, tabs, k=k, L=L, W=W)
    if kind == "encode":
        ms, _ = cuda_ms(lambda: PL.encode_lanes(blocks, tabs, k=k, L=L, W=W),
                        reps=REPS)
    else:
        ms, _ = cuda_ms(lambda: PL.decode_lanes(words, sizes, tabs.dec, L=L,
                                                R=R), reps=REPS)
    return ms * 1e6 / R


def load_sweep(data: np.ndarray, name: str = "throughput",
               Bs=(1, 2, 4, 8)) -> dict:
    """ns a round of B1 and B2 at ``name``'s k and L for B blocks: the
    lanes an SM holds double with B (B=4 is the launch shape). A round
    that takes as long at B as at B/2 is bound by its chain; one that
    takes twice as long is bound by what the SM's warps share."""
    s = SHAPES[name]
    out = {}
    for B in Bs:
        inp = launch_inputs(f"{name}_B{B}", B, s["block"], s["k"], s["L"],
                            data)
        out[B] = {kind: cuda_ms(lambda: run_new(kind, inp), reps=REPS)[0]
                  * 1e6 / inp.R for kind in ("encode", "decode")}
        del inp
    return out


def run_new(kind: str, inp: ShapeInputs):
    if kind == "encode":
        return PL.encode_lanes(inp.blocks, inp.tabs, k=inp.k, L=inp.L, W=inp.W)
    return PL.decode_lanes(inp.words, inp.sizes, inp.tabs.dec, L=inp.L, R=inp.R)


# --- another commit's kernels, for timing in turns -----------------------------


def load_old(old_root: Path) -> tuple[ctypes.CDLL, Path]:
    """Build ``old_root``'s B1 and B2 sources into a library of their own
    (nvcc, the current flags) and load it."""
    from ..kernels import build as KB

    srcs = [old_root / "entropy_coders_tpu_torch" / "csrc" / f"{n}.cu"
            for n in ("pl_encode", "pl_decode")]
    h = hashlib.sha256(b"".join(s.read_bytes() for s in srcs)).hexdigest()[:16]
    out = KB.build_dir() / f"libect_torch_old_{h}.so"
    if not out.exists():
        KB.writable_build_dir()
        flags = [f for f in KB.COMPILE_FLAGS if f != "-c"]
        r = subprocess.run([KB._nvcc(), *flags, "-shared", "-o", str(out),
                            *map(str, srcs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old kernels:\n{r.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ect_pl_encode.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.ect_pl_decode.argtypes = [P] * 6 + [I] * 5 + [P]
    return lib, out


def run_old(lib, kind: str, inp: ShapeInputs):
    dev = inp.blocks.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    B, k, L, R, W = inp.B, inp.k, inp.L, inp.R, inp.W
    if kind == "encode":
        words = torch.zeros((B, W, k), dtype=torch.int32, device=dev)
        sizes = torch.empty((B, k), dtype=torch.int32, device=dev)
        t = inp.tabs
        rc = lib.ect_pl_encode(inp.blocks.data_ptr(), t.tt_bits.data_ptr(),
                               t.tt_fs.data_ptr(), t.next_state.data_ptr(),
                               words.data_ptr(), sizes.data_ptr(), B, k, L, R,
                               W, stream)
        out = (words.view(torch.uint32), sizes)
    else:
        out = (torch.empty((B, R, k), dtype=torch.uint8, device=dev),
               torch.empty((B, k), dtype=torch.uint8, device=dev),
               torch.empty((B, k), dtype=torch.int32, device=dev))
        rc = lib.ect_pl_decode(inp.words.data_ptr(), inp.sizes.data_ptr(),
                               inp.tabs.dec.data_ptr(), *(o.data_ptr() for o in out),
                               B, inp.W, k, L, R, stream)
    if rc != 0:
        raise RuntimeError(f"old {kind} kernel launch failed: CUDA error {rc}")
    return out


def _equal(a, b) -> bool:
    from ..ops.unsigned import signed_view

    return all(torch.equal(signed_view(x), signed_view(y)) for x, y in zip(a, b))


def in_turns(old_lib, inp: ShapeInputs, rounds: int) -> dict:
    """Old and new B1 and B2 on ``inp`` in turns (old, new, new, old) x
    ``rounds``, each turn the median of 5 timed runs of REPS launches;
    outputs equal."""
    out = {}
    for kind in ("encode", "decode"):
        if not _equal(run_old(old_lib, kind, inp), run_new(kind, inp)):
            raise AssertionError(f"{inp.name} {kind}: old and new kernels differ")
        times = {"old": [], "new": []}
        for who in ["old", "new", "new", "old"] * rounds:
            fn = ((lambda: run_old(old_lib, kind, inp)) if who == "old"
                  else (lambda: run_new(kind, inp)))
            times[who].append(cuda_ms(fn, runs=5, warmup=1, reps=REPS)[0])
        out[kind] = {"old_ms": statistics.median(times["old"]),
                     "new_ms": statistics.median(times["new"]),
                     "old_ms_turns": times["old"], "new_ms_turns": times["new"]}
    return out


def run_threads(lib, kind: str, inp: ShapeInputs, T: int):
    """``run_new`` with T threads a CTA instead of the wrapper's pick (the
    group of rounds as ``PL.lane_config`` picks it). Raises when the launch
    fails, e.g. when T's shared memory does not fit."""
    dev = inp.blocks.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    B, k, L, R, W = inp.B, inp.k, inp.L, inp.R, inp.W
    group = PL.lane_config(kind, k, L)[1]
    if kind == "encode":
        words = torch.empty((B, W, k), dtype=torch.int32, device=dev)
        sizes = torch.empty((B, k), dtype=torch.int32, device=dev)
        t = inp.tabs
        rc = lib.ect_pl_encode(inp.blocks.data_ptr(), t.tt_bits.data_ptr(),
                               t.tt_fs.data_ptr(), t.next_state.data_ptr(),
                               words.data_ptr(), sizes.data_ptr(), B, k, L, R,
                               W, T, group, stream)
        out = (words.view(torch.uint32), sizes)
    else:
        out = (torch.empty((B, R, k), dtype=torch.uint8, device=dev),
               torch.empty((B, k), dtype=torch.uint8, device=dev),
               torch.empty((B, k), dtype=torch.int32, device=dev))
        rc = lib.ect_pl_decode(inp.words.data_ptr(), inp.sizes.data_ptr(),
                               inp.tabs.dec.data_ptr(),
                               *(o.data_ptr() for o in out), B, W, k, L, R, T,
                               group, stream)
    if rc != 0:
        raise RuntimeError(f"{kind} at T={T}: CUDA error {rc}")
    return out


def sweep_threads(kind: str, inp: ShapeInputs) -> dict:
    """ms of one ``kind`` launch on ``inp`` at each CTA size in THREADS that
    divides k (None where its shared memory does not fit); every output
    equal to the wrapper's."""
    from ..kernels.build import load

    lib, out = load(), {}
    want = run_new(kind, inp)
    for T in THREADS:
        if inp.k % T:
            continue
        try:
            got = run_threads(lib, kind, inp, T)
        except RuntimeError:
            out[T] = None
            continue
        if not _equal(got, want):
            raise AssertionError(f"{inp.name} {kind}: T={T} differs")
        out[T] = cuda_ms(lambda: run_threads(lib, kind, inp, T), reps=REPS)[0]
    return out


# --- what the SASS says: instructions by pipe, the dependent chain ------------


def sass(lib_path: Path, dst: Path | None = None) -> str:
    """``cuobjdump -sass`` of a library (written to ``dst`` when given)."""
    from ..kernels import build as KB

    cuobjdump = Path(KB._nvcc()).with_name("cuobjdump")
    r = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({r.returncode}):\n{r.stderr}")
    if dst is not None:
        dst.write_text(r.stdout)
    return r.stdout


class Insn(NamedTuple):
    """One SASS instruction: its opcode with modifiers, the registers it
    writes and reads (its guard predicate among them), whether it has a
    guard."""
    op: str
    dests: tuple
    srcs: tuple
    guarded: bool


_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?(?:U?P\d|U?PT)\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_REG = re.compile(r"\b(U?R|U?P)(\d+)(\.64)?\b")
_PRED = re.compile(r"!?U?P(?:\d|T)")
# opcodes that write no register (a store's first operand is an address)
_NO_DEST = {"BAR", "BRA", "BSSY", "BSYNC", "CALL", "CCTL", "DEPBAR", "ERRBAR",
            "EXIT", "LDGDEPBAR", "LDGSTS", "MEMBAR", "NOP", "RED", "RET",
            "WARPSYNC", "YIELD"}
_ALU = {"BMSK", "BREV", "FLO", "IABS", "IADD3", "IMNMX", "ISETP", "LEA",
        "LOP3", "PLOP3", "POPC", "PRMT", "SEL", "SGXT", "SHF"}
_FMA = {"IMAD", "IMUL"}


def _regs(text: str, width: int = 1) -> list:
    out = []
    for pre, n, wide in _REG.findall(text):
        w = max(width, 2 if wide else 1)
        out += [f"{pre}{int(n) + j}" for j in range(w)]
    return out


def parse_sass(body: str) -> list:
    """The instructions of a ``cuobjdump -sass`` listing, in order."""
    insns = []
    for m in _LINE.finditer(body):
        guard, op, args = m.group(1), m.group(2), m.group(3)
        base = op.split(".")[0]
        operands = [a.strip() for a in args.split(",")] if args.strip() else []
        n_dest = 0
        if operands and not (base.startswith("ST") or base in _NO_DEST):
            n_dest = 1  # a leading predicate after the first is written too
            if len(operands) >= 4 and _PRED.fullmatch(operands[1]):
                n_dest = 2
        width = (4 if ".128" in op else
                 2 if ".WIDE" in op or (base.startswith("LD") and ".64" in op)
                 else 1)
        dests = _regs(operands[0], width) if n_dest else []
        if n_dest == 2:
            dests += _regs(operands[1])
        srcs = [r for o in operands[n_dest:] for r in _regs(o)]
        if guard:
            srcs += _regs(guard)
        insns.append(Insn(op, tuple(dests), tuple(srcs), bool(guard)))
    return insns


def pipes(op: str) -> list:
    """The pipes an instruction takes a slot of (``PIPES``): every one
    issues; integer arithmetic and logic go to the ALU, IMAD to the FMA
    pipe, loads and stores to the load/store path. Uniform-datapath
    instructions (U...) and those of no listed pipe only issue."""
    base = op.split(".")[0]
    out = ["issue"]
    if base in _ALU:
        out.append("alu")
    elif base in _FMA:
        out.append("fma")
    elif base.startswith(("LD", "ST", "ATOM", "RED")):
        out.append("lsu")
    return out


def latency(op: str, lat: dict) -> float:
    """Cycles from ``op``'s issue to its result, from the measured ``lat``
    (``latencies``): loads take the shared-memory load's (a global load
    takes longer), IMAD and IMUL the IMAD's, LOP3 and SHF their own, and
    every other instruction the least of those three, so the chain stays a
    floor."""
    base = op.split(".")[0]
    if base.startswith("LD"):
        return lat["LDS"]
    if base in _FMA:
        return lat["IMAD"]
    if base in ("LOP3", "SHF"):
        return lat[base]
    return min(lat["SHF"], lat["LOP3"], lat["IMAD"])


def chain_cycles(insns: list, lat: dict) -> float:
    """Cycles of the longest chain of register dependences through
    ``insns``, each instruction starting when its last source is ready and
    taking its ``latency``; issue slots are free. A guarded instruction is
    taken as running, then as not running; the smaller result stands, so
    the chain stays a floor whichever way the predicates go."""
    def longest(runs_guarded: bool) -> float:
        ready, end = {}, 0.0
        for x in insns:
            if not x.dests or (x.guarded and not runs_guarded):
                continue
            t = max((ready.get(r, 0.0) for r in x.srcs), default=0.0)
            done = t + latency(x.op, lat)
            for d in x.dests:
                ready[d] = max(ready.get(d, 0.0), done) if x.guarded else done
            end = max(end, done)
        return end

    return min(longest(True), longest(False))


def inorder_cycles(insns: list, lat: dict) -> float:
    """Cycles one warp alone takes through ``insns`` in program order: an
    instruction issues a cycle after the one before it, or when its last
    source is ready if that is later (a warp issues in order, so one
    waiting instruction holds back those behind it). Not a floor of the
    work, as ``chain_cycles`` is: the order is the compiler's."""
    ready, t = {}, -1.0  # the first issues at cycle 0
    for x in insns:
        t = max([t + 1.0] + [ready.get(r, 0.0) for r in x.srcs])
        for d in x.dests:
            ready[d] = t + latency(x.op, lat)
    return max([t] + list(ready.values()))


# one instruction a round marks the rounds of a kernel's unrolled loop: B1
# stores each round's symbol (STS.U8), B2 loads each round's (LDS.U8)
_ROUND_MARK = {"decode": "STS.U8", "encode": "LDS.U8"}


def sass_function(text: str, name: str) -> str | None:
    """The SASS of the function whose (mangled) name matches ``name``."""
    head = re.search(rf"Function : \S*{name}\S*", text)
    if head is None:
        return None
    body = text[head.end():]
    nxt = body.find("Function : ")
    return body[: nxt if nxt >= 0 else None]


def _insns_text(body: str) -> list:
    """A function's SASS as its instructions' text, addresses and
    encodings left out."""
    return ["".join(m.group(i) or "" for i in (1, 2, 3)).strip()
            for m in _LINE.finditer(body)]


# B1 in a build: lane_decode_kernel<FlatFormat, T, RF> of pl_decode.cu (the
# layout kernel's flat instantiation lives in pl_decode_layout.cu's own
# namespace), or pl_decode_kernel<T, RF> before the kernel moved into
# lane_decode.cuh
B1_SASS = (r"(?:pl_decode_kernelI|_pl_decode_cu_\S*lane_decode_kernelI\S*"
           r"FlatFormatE)Li{T}ELi{RF}E")
FLAT_LAYOUT_SASS = (r"_pl_decode_layout_cu_\S*lane_decode_kernelI\S*"
                    r"FlatFormatELi{T}ELi{RF}E")


def sass_diff(text_a: str, pat_a: str, text_b: str, pat_b: str) -> dict:
    """Two kernels' SASS (the functions matching ``pat_a`` in ``text_a``
    and ``pat_b`` in ``text_b``, each pattern formatted with the
    instantiation's T and RF), instantiation by instantiation: the
    instructions that differ, position by position, and both counts (0
    and equal counts: the same code). None where one is missing."""
    out = {}
    for T in (128, 256, 512):
        for RF in (1, 2):
            bodies = [sass_function(text, pat.format(T=T, RF=RF))
                      for text, pat in ((text_a, pat_a), (text_b, pat_b))]
            if None in bodies:
                out[f"T{T}_RF{RF}"] = None
                continue
            a, b = map(_insns_text, bodies)
            out[f"T{T}_RF{RF}"] = {
                "differ": sum(x != y for x, y in zip(a, b)),
                "count": [len(a), len(b)]}
    return out


def b1_sass_diff(old_text: str, new_text: str) -> dict:
    """B1's SASS in two builds (``sass_diff``)."""
    return sass_diff(old_text, B1_SASS, new_text, B1_SASS)


def round_stats(text: str, kind: str, T: int, group: int,
                lat: dict) -> dict | None:
    """Per round of the ``kind`` kernel built for T threads and ``group``
    (B2's F, B1's RF), from ``cuobjdump -sass`` text: the instructions a
    warp issues in each pipe (``pipes``), the cycles of the dependent chain
    (``chain_cycles`` with latencies ``lat``) and of one warp alone in
    program order (``inorder_cycles``), over the unrolled tile's tightest
    run of 32 round marks (31 rounds). None when the function is not in
    ``text``."""
    pat = B1_SASS if kind == "decode" else "pl_encode_kernelILi{T}ELi{RF}E"
    body = sass_function(text, pat.format(T=T, RF=group))
    if body is None:
        return None
    insns = parse_sass(body)
    marks = [i for i, x in enumerate(insns) if x.op == _ROUND_MARK[kind]]
    spans = [(b - a, a, b) for a, b in zip(marks, marks[31:])]
    if not spans:
        return None
    _, a, b = min(spans)
    tile = insns[a:b]
    count = Counter(p for x in tile for p in pipes(x.op))
    return {"per_round": {p: count[p] / 31 for p in PIPES},
            "chain_cycles": chain_cycles(tile, lat) / 31,
            "inorder_cycles": inorder_cycles(tile, lat) / 31}


def kernel_stats(kind: str, k: int, L: int, text: str, lat: dict) -> dict:
    """``round_stats`` of the instantiation the wrapper launches for k
    lanes at table log L."""
    T, group = PL.lane_config(kind, k, L)
    st = round_stats(text, kind, T, group, lat)
    if st is None:
        raise RuntimeError(f"no unrolled tile of {kind} T={T} group={group} "
                           "in the SASS")
    return st


# op codes of ``ect_latency`` (csrc/latency.cu); ADD_SHF is a pair, an add
# and a dependent SHF (the add compiles to IMAD.IADD, IADD3 or VIADD)
LATENCY_OPS = ("SHF", "LOP3", "IMAD", "ADD_SHF", "LDS")


def latencies(iters: int = 4096) -> dict:
    """Cycles from issue to result of SHF, LOP3, IMAD, an add followed by
    an SHF (the pair) and a shared-memory load, each the mean over a
    dependent chain of 32 * iters steps run by one thread on the current
    card."""
    from ..kernels.build import load

    lib, out = load(), {}
    for op, name in enumerate(LATENCY_OPS):
        cycles = ctypes.c_longlong()
        rc = lib.ect_latency(op, iters, ctypes.addressof(cycles))
        if rc != 0:
            raise RuntimeError(f"latency {name}: CUDA error {rc}")
        out[name] = cycles.value / (32 * iters)
    return out


def latency_sass(text: str) -> dict:
    """The opcodes of each ``latency_kernel<op>`` in ``text`` and their
    counts: what each measured chain compiled to."""
    out = {}
    for op, name in enumerate(LATENCY_OPS):
        body = sass_function(text, f"latency_kernelILi{op}E")
        if body is not None:
            ops = Counter(x.op for x in parse_sass(body))
            out[name] = dict(ops.most_common(6))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="checkout of another commit")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sass", type=Path, help="directory for cuobjdump -sass")
    ap.add_argument("--sweep", action="store_true",
                    help="add HIGH_SHAPES and time every CTA size")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lane_shapes: no CUDA device", file=sys.stderr)
        return 2
    from ..kernels import build as KB

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    old_lib = None
    if args.sass is not None:
        args.sass.mkdir(parents=True, exist_ok=True)
    text = sass(KB.build(), args.sass and args.sass / "new.sass")
    if args.old is not None:
        old_lib, old_path = load_old(args.old)
        if args.sass is not None:
            sass(old_path, args.sass / "old.sass")
    lat = latencies()
    data = gen_sequence(0.2, 64 * MIB)
    clocks = card_clocks()
    alone = {f"{kind}_L{L}": alone_ns(kind, L)
             for kind in ("decode", "encode") for L in (8, 10, 11)}
    print(json.dumps({"card": card, "clocks": clocks, "latency_cycles": lat,
                      "latency_sass": latency_sass(text), "alone_ns": alone,
                      "round_ns_by_blocks": load_sweep(data)}), flush=True)
    names = list(SHAPES) + (list(HIGH_SHAPES) if args.sweep else [])
    for name in names:
        inp = shape_inputs(name, data)
        row = {"shape": name, "B": inp.B, "k": inp.k, "L": inp.L, "R": inp.R,
               "W": inp.W}
        for kind in ("encode", "decode"):
            st = kernel_stats(kind, inp.k, inp.L, text, lat)
            b = shape_bound(kind, inp, st, clocks["sm_max_mhz"])
            ms = cuda_ms(lambda: run_new(kind, inp), reps=REPS)[0]
            row[kind] = {"ms": ms, "threads": PL.lane_config(kind, inp.k,
                                                             inp.L)[0],
                         **st, **b, "share": b["bound_ms"] / ms,
                         "share3": b["bound3_ms"] / ms}
            if args.sweep:
                row[kind]["ms_by_threads"] = sweep_threads(kind, inp)
        if old_lib is not None:
            row["in_turns"] = in_turns(old_lib, inp, args.rounds)
        row["clocks_after"] = card_clocks()
        print(json.dumps(row), flush=True)
        del inp
    return 0


if __name__ == "__main__":
    sys.exit(main())

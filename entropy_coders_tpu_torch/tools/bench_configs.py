"""The BASELINE configs 1-6 on the port, on the repository's own corpora.

Counterpart of the root ``bench_configs.py``: the same stand-in corpora,
byte for byte for the same tree and seeds, and the same six configs, each
printing one JSON line with the JAX script's keys (and a few of its own:
each corpus's sha256, the blocks the decode rate counted). Every compress
passes ``lanes=True``, and every round trip is checked exact.

* ``ascii`` — the repository's root ``*.md`` and ``*.py`` files cycled, so
  the text corpora (``ascii_block``, ``mixed_buffer``, ``corpus``,
  ``mixed_corpus``) follow the tree they are built in: their ratios hold
  for one tree, named by the sha256 printed beside them;
* ``mixed`` — text + seeded random bytes + runs (config 2's recipe);
* ``corpus`` — the text with seeded Zipf-ish noise on 10% of positions;
* ``bf16`` — bf16 weights at per-tensor scales 1e-3..1, through
  ``torch.bfloat16`` (the JAX script's ``ml_dtypes`` gives the same bytes);
* ``jsonlog`` — newline-delimited JSON log records;
* ``mixed_corpus`` — text, bf16 and jsonlog in 256 KiB stripes;
* ``geo`` — the bench corpus ``gen_sequence(0.2)``.

``device_decode_gbps`` is the counterpart of ``_device_decode_gbps``: B1's
rate on the per-lane blocks of a frame, timed with CUDA events. It takes
B1's blocks as they are, without the JAX helper's TPU layout (superblock
fusing, u-packed rows, expanded tables). There is no host-clock fallback:
the timer raises without CUDA, and off CUDA the configs leave the rate out,
as the JAX script does off a TPU.

Usage, on a machine with a CUDA device (the configs run on ``"cuda"``; the
tests run them on ``device="cpu"`` at small sizes):

    python -m entropy_coders_tpu_torch.tools.bench_configs [1..6]
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..builddir import is_checkout
from ..frame import _tl, compress, decompress
from ..ops import pl_coder as PL
from ..ops.coder import decode_interleaved, encode_interleaved
from ..ops.unsigned import resolve_device, to_numpy
from ..parallel import block_sharding, default_mesh
from .bench_data import cuda_ms, gen_sequence, pl_blocks
from .l10_attack import frame_lanes

MIB = 1 << 20
CORPUS_BYTES = 32 * MIB  # configs 3 and 6 and the policy sweep
CONFIG3 = dict(block_size=128 << 10, k=1024)
CONFIG4 = dict(block_size=4 * MIB, k=8192)
THROUGHPUT = dict(block_size=16 * MIB, k=16384, table_log=8)
PARITY = dict(block_size=16 * MIB, k=8192, table_log=11, bit_pack=True)


def _require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


# --- corpora -------------------------------------------------------------------


def checkout_root() -> Path:
    """The root of the checkout this package lies in, where the root
    ``bench_configs.py`` reads its text. Raises RuntimeError for an
    installed package: there is no tree to read."""
    root = Path(__file__).resolve().parents[2]
    if not is_checkout(root):
        raise RuntimeError(f"{root} is not a checkout of the repository; "
                           "pass root= to read the text corpus elsewhere")
    return root


def _repo_text(root=None) -> bytes:
    """Every ``*.md`` and ``*.py`` file at ``root`` (default: the
    checkout's root), in sorted order, concatenated."""
    root = checkout_root() if root is None else Path(root)
    return b"".join((root / f).read_bytes()
                    for f in sorted(p.name for p in root.iterdir())
                    if f.endswith((".md", ".py")))


def _cycle(text: bytes, n: int) -> bytes:
    return (text * (n // len(text) + 1))[:n]


def ascii_block(n: int, root=None) -> bytes:
    return _cycle(_repo_text(root), n)


def mixed_buffer(n: int, seed=1, root=None) -> bytes:
    """Config 2's recipe: text + random + runs."""
    text = _repo_text(root)
    rng = np.random.default_rng(seed)
    parts, m = [], 0
    while m < n:
        kind = rng.integers(0, 3)
        ln = int(rng.integers(4 << 10, 64 << 10))
        if kind == 0:
            parts.append(_cycle(text, ln))
        elif kind == 1:
            parts.append(rng.integers(0, 256, ln, dtype=np.uint8).tobytes())
        else:
            parts.append(bytes([int(rng.integers(0, 256))]) * ln)
        m += ln
    return b"".join(parts)[:n]


def corpus(n: int, seed=2, root=None) -> bytes:
    """enwik stand-in: text-heavy with seeded noise mixed in."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(ascii_block(n, root), np.uint8).copy()
    # Zipf-ish byte noise over 10% of positions so that blocks differ
    idx = rng.integers(0, n, n // 10)
    text[idx] = (rng.zipf(1.4, n // 10) % 256).astype(np.uint8)
    return text.tobytes()


def bf16_tensor_bytes(n: int, seed: int = 3) -> bytes:
    """Model-state stand-in: bf16 weights at layer-realistic scales
    (per-tensor std 1e-3..1). float64 -> bf16 rounds as ``ml_dtypes``
    rounds it, so the bytes are the JAX script's."""
    rng = np.random.default_rng(seed)
    out, m = [], 0
    while m < n:
        ln = int(rng.integers(64 << 10, 1 << 20))
        std = 10.0 ** rng.uniform(-3, 0)
        t = torch.from_numpy(rng.standard_normal(ln // 2) * std).to(
            torch.bfloat16)
        b = t.view(torch.uint8).numpy().tobytes()
        out.append(b)
        m += len(b)
    return b"".join(out)[:n]


def json_log_bytes(n: int, seed: int = 4) -> bytes:
    """Structured-log stand-in: newline-delimited JSON records with
    repeated keys, monotone timestamps, mixed numeric/string values."""
    rng = np.random.default_rng(seed)
    levels = ["INFO", "WARN", "ERROR", "DEBUG"]
    hosts = [f"worker-{i:03d}" for i in range(32)]
    out, m, ts = [], 0, 1_723_000_000.0
    while m < n:
        ts += float(rng.exponential(0.02))
        rec = {
            "ts": round(ts, 6),
            "level": levels[int(rng.integers(0, 4))],
            "host": hosts[int(rng.integers(0, 32))],
            "step": int(rng.integers(0, 1 << 20)),
            "loss": round(float(rng.gamma(2.0, 0.3)), 5),
            "tokens_per_s": int(rng.integers(10_000, 500_000)),
            "msg": "step completed" if rng.random() < 0.9
                   else "retrying collective (transient ICI timeout)",
        }
        b = (json.dumps(rec, separators=(",", ":")) + "\n").encode()
        out.append(b)
        m += len(b)
    return b"".join(out)[:n]


def mixed_corpus(n: int, seed: int = 5, root=None) -> bytes:
    """Source text + bf16 tensor bytes + JSON-log bytes in 1/3 shares,
    interleaved in 256 KiB stripes so that every 16 MiB block sees all
    three."""
    third = n // 3
    parts = [np.frombuffer(corpus(third, seed, root), np.uint8),
             np.frombuffer(bf16_tensor_bytes(third, seed + 1), np.uint8),
             np.frombuffer(json_log_bytes(n - 2 * third, seed + 2),
                           np.uint8)]
    stripe = 256 << 10
    out, idx = [], [0, 0, 0]
    while sum(idx) < n:
        for j, p in enumerate(parts):
            if idx[j] < len(p):
                out.append(p[idx[j]: idx[j] + stripe])
                idx[j] += stripe
    return b"".join(x.tobytes() for x in out)[:n]


class Corpora:
    """Each corpus built once, at each size asked for: config 6, config 3
    and the policy sweep share them (``json_log_bytes`` alone takes
    seconds at 32 MiB). ``root`` is the tree the text corpora read."""

    def __init__(self, root=None):
        self.root = root
        self._made: dict = {}

    def get(self, name: str, n: int) -> np.ndarray:
        """Corpus ``name`` (geo, text, bf16, jsonlog, mixed) of ``n`` bytes
        as read-only uint8."""
        if (name, n) not in self._made:
            build = {"geo": lambda: gen_sequence(0.2, n).tobytes(),
                     "text": lambda: corpus(n, root=self.root),
                     "bf16": lambda: bf16_tensor_bytes(n),
                     "jsonlog": lambda: json_log_bytes(n),
                     "mixed": lambda: mixed_corpus(n, root=self.root)}[name]
            self._made[name, n] = np.frombuffer(build(), np.uint8)
        return self._made[name, n]

    def sha256(self, name: str, n: int) -> str:
        return hashlib.sha256(self.get(name, n)).hexdigest()

    def built(self) -> list:
        """(name, n) of every corpus built so far, in the order built."""
        return list(self._made)


# --- the decode-rate timer -------------------------------------------------------


# GPU cycles the card spins before each timed run (~10 ms at the H100's
# 1.98 GHz): the host queues the run's calls meanwhile. A call's host
# enqueue (the wrapper's checks, three output tensors, the ctypes launch)
# takes about as long as B1 on a 32 MiB frame, so without it the events
# would time the host.
HOLD_CYCLES = 20_000_000


class DecodeRate(NamedTuple):
    """B1's rate on a frame's per-lane blocks (``device_decode_gbps``)."""
    GBps: float      # raw bytes of the blocks decoded over the median time
    ms: float        # median device time of one B1 call (CUDA events)
    runs_ms: list    # every run's time a call
    enqueue_ms: float  # host time to queue one call (host clock)
    L: int           # the table log of the blocks decoded
    blocks: int      # blocks one call decodes
    n_blocks: int    # blocks in the frame
    launches: int    # B1 calls this timer made (each one launch)


def device_decode_gbps(frame: bytes, block_size: int, k: int, *, data,
                       device="cuda", runs: int = 7,
                       reps: int = 24) -> DecodeRate:
    """B1's decode rate on ``frame``, the frame of ``data``: the blocks the
    JAX helper selects (MODE_FSE_PL, the shared table when there is one,
    the first such block's table log; ``bench_data.pl_blocks``) laid out as
    B1 takes them, (B, W, k) words, (B, k) sizes and (B, 2^L) tables, and
    one ``pl_coder.decode_call`` over all of them timed by ``held_ms``:
    ``runs`` runs of ``reps`` calls, each run queued behind a spin of
    ``HOLD_CYCLES`` so that the calls run back to back (the JAX helper
    takes the marginal time of 24 pipelined calls for the same reason),
    and the host's time to queue a call. Every cursor must drain to 0 and
    the symbols must equal ``data``'s bytes (``check_decoded``), or it
    raises RuntimeError. Raises without CUDA: a rate is a device number."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_decode_gbps times B1 on a CUDA device, "
                         f"not {dev}")
    inp = frame_lanes(frame, data, block_size=block_size, k=k, device=dev,
                      select=True)
    calls = [0]

    def call():
        calls[0] += 1
        return PL.decode_call(inp.words, inp.sizes, inp.dec, L=inp.L,
                              R=inp.R)

    check_decoded(inp, call())
    ms, runs_ms, enqueue_ms = held_ms(call, dev, runs=runs, reps=reps)
    B = inp.words.shape[0]
    return DecodeRate(B * block_size / ms / 1e6, ms, runs_ms, enqueue_ms,
                      inp.L, B, inp.n_blocks, calls[0])


def check_decoded(inp, out) -> None:
    """Raise RuntimeError unless ``out``, B1's (or its plain version's)
    (syms, finals, cursors) on ``inp`` (``l10_attack.frame_lanes``), has
    every cursor drained to 0 and gives ``inp.data`` back byte for byte."""
    syms, finals, cursors = out
    B, _, k = inp.words.shape
    _require(not bool(cursors.any()), "the decode: a cursor did not drain "
             "to 0")
    want = torch.from_numpy(inp.data).to(syms.device).reshape(B, inp.R + 1,
                                                              k)
    _require(torch.equal(syms, want[:, :inp.R])
             and torch.equal(finals, want[:, inp.R]),
             "the decode: decoded bytes differ from the input")


def held_ms(call, dev, *, runs: int, reps: int):
    """(median ms a call, every run's ms a call, host ms to queue a call)
    of ``call`` on CUDA device ``dev``: ``bench_data.cuda_ms`` with
    ``reps`` calls a run, each run queued behind a spin of
    ``HOLD_CYCLES``; then one more batch of ``reps`` calls, queued behind
    a spin, on the host clock."""
    with torch.cuda.device(dev):
        ms, runs_ms = cuda_ms(call, runs=runs, reps=reps,
                              hold_cycles=HOLD_CYCLES)
        torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize(dev)
    return ms, runs_ms, enqueue_ms


class EncodeInputs(NamedTuple):
    """A frame's blocks as B2 takes them, and what B2 must give back."""
    blocks: torch.Tensor       # (B, block_size) uint8 raw bytes
    tables: PL.LaneTables      # the encode half of the frame's tables
    L: int
    W: int                     # word rows: encode_w_bound(R, L)
    sizes: np.ndarray          # (B, k) the frame's lane sizes in bits
    payloads: list             # the frame's B wire payloads
    bit_packed: bool


def encode_inputs(frame: bytes, data, block_size: int, k: int,
                  device) -> EncodeInputs:
    """``frame``'s blocks (all MODE_FSE_PL, each with its own table, one
    table log: ``bench_data.pl_blocks``), ``data``'s bytes, and the encode
    half of their tables built on ``device``."""
    blk = pl_blocks(frame, block_size, k)
    dev = torch.device(device)
    raw = np.asarray(data, np.uint8)[: len(blk.ids) * block_size]
    return EncodeInputs(
        torch.from_numpy(raw.reshape(-1, block_size)).to(dev),
        PL.tables_from_norm(blk.norm_tables, blk.L, dev, half="encode"),
        blk.L, PL.encode_w_bound(block_size // k - 1, blk.L), blk.sizes,
        blk.payloads, blk.bit_packed)


def encode_call(inp: EncodeInputs):
    """One ``pl_coder.encode_call`` over all of ``inp``'s blocks."""
    return PL.encode_call(inp.blocks, inp.tables, k=inp.sizes.shape[1],
                          L=inp.L, W=inp.W)


def check_encoded(inp: EncodeInputs, out) -> None:
    """Raise RuntimeError unless ``out``, B2's (or its plain version's)
    (words, sizes) on ``inp``, gives the frame's lane sizes and, merged by
    the host library (``pl_coder.lane_merge_batch``, the frame's wire
    form), the frame's payloads byte for byte."""
    words, sizes = out
    _require(np.array_equal(sizes.cpu().numpy(), inp.sizes),
             "the encode: lane sizes differ from the frame's")
    merged = PL.lane_merge_batch(to_numpy(words), inp.sizes,
                                 inp.bit_packed)
    _require(merged == [bytes(p) for p in inp.payloads],
             "the encode: merged lanes differ from the frame's payloads")


class EncodeRate(NamedTuple):
    """B2's rate on a frame's blocks (``device_encode_gbps``)."""
    GBps: float        # raw bytes encoded over the median time
    ms: float          # median device time of one B2 call (CUDA events)
    runs_ms: list      # every run's time a call
    enqueue_ms: float  # host time to queue one call (host clock)
    L: int             # the table log of the blocks
    blocks: int        # blocks one call encodes
    launches: int      # B2 calls this timer made (each one launch)


def device_encode_gbps(frame: bytes, data, block_size: int, k: int, *,
                       device="cuda", runs: int = 7,
                       reps: int = 24) -> EncodeRate:
    """B2's encode rate at ``frame``'s tables: ``frame``'s blocks, the
    encode half of their tables built on the card, and one
    ``pl_coder.encode_call`` over all of them into
    ``encode_w_bound(R, L)`` word rows, held exactly against the frame
    (``check_encoded``: RuntimeError otherwise), then timed as
    ``device_decode_gbps`` times B1 (``held_ms``). Raises without CUDA:
    a rate is a device number."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_encode_gbps times B2 on a CUDA device, "
                         f"not {dev}")
    inp = encode_inputs(frame, data, block_size, k, dev)
    calls = [0]

    def call():
        calls[0] += 1
        return encode_call(inp)

    check_encoded(inp, call())
    ms, runs_ms, enqueue_ms = held_ms(call, dev, runs=runs, reps=reps)
    B = inp.blocks.shape[0]
    return EncodeRate(B * block_size / ms / 1e6, ms, runs_ms, enqueue_ms,
                      inp.L, B, calls[0])


def _rate_fields(rate: DecodeRate, key: str) -> dict:
    """The JSON fields of a rate: the JAX script's key, then ours."""
    return {key: rate.GBps, "decode_ms": rate.ms,
            "decode_ms_runs": rate.runs_ms,
            "decode_enqueue_ms": rate.enqueue_ms, "decode_L": rate.L,
            "decode_blocks": rate.blocks, "frame_blocks": rate.n_blocks,
            "decode_launches": rate.launches}


# --- the configs ------------------------------------------------------------------


def coder_frame(data, k: int, log2: int = -1, device="cuda") -> bytes:
    """The reference format's k-stream frame of ``data``: the histogram
    header, then ``ops.coder.encode_interleaved``'s payload (the JAX
    package's ``fse_compress``; ``log2=-1`` is its default table log)."""
    src = np.frombuffer(bytes(data), np.uint8)
    table, l2 = native.normalize(np.bincount(src, minlength=256), len(src),
                                 log2)
    enc = native.build_encode_tables(table[None], l2)
    payload, _ = encode_interleaved(
        src, k, SimpleNamespace(table=enc[0][0], tt_bits=enc[1][0],
                                tt_find_state=enc[2][0]), l2, device=device)
    return native.write_header(table, l2, _tl(table)) + payload


def coder_unframe(frame: bytes, k: int, max_out: int, device="cuda"):
    """Inverse of ``coder_frame`` (``ops.coder.decode_interleaved``): the
    bytes, or None on a framing error."""
    table, l2, _, n = native.read_header(frame)
    dec = SimpleNamespace(packed=native.build_decode_tables(table[None],
                                                            l2)[0])
    return decode_interleaved(frame[n:], k, dec, l2, max_out, device=device)


def config1(device="cuda", corpora=None):
    """64 KiB ASCII, single stream, 12-bit table (the reference's own
    shape): the port's shared-stream coder (kernels D4/D5 on CUDA) for
    exactness, its wall times (``coder_encode_s``/``coder_decode_s``, host
    clock, the table build and copies included) beside the C++ host
    codec's (``host_encode_s``, and ``host_decode_MBps``: 20 decodes)."""
    data = ascii_block(64 << 10, (corpora or Corpora()).root)
    t0 = time.perf_counter()
    frame = coder_frame(data, 1, 12, device)
    t1 = time.perf_counter()
    back = coder_unframe(frame, 1, len(data) + 16, device)
    t2 = time.perf_counter()
    _require(back == data, "config 1: the coder's round trip")
    res = {"config": 1, "workload": "64KiB ascii, k=1, L=12",
           "ratio": len(frame) / len(data), "roundtrip": "exact",
           "corpus_sha256": hashlib.sha256(data).hexdigest(),
           "coder_encode_s": t1 - t0, "coder_decode_s": t2 - t1}
    t0 = time.perf_counter()
    nf = native.compress(data, k=1)
    res["host_encode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(20):
        back = native.decompress(nf, k=1, max_out=len(data) + 16)
    res["host_decode_MBps"] = len(data) * 20 / (time.perf_counter() - t0) / 1e6
    _require(back == data, "config 1: the host codec's round trip")
    return res


def config2(device="cuda", corpora=None):
    """1 MiB mixed-entropy, k=2 (the reference's own two-stream format)
    and k=4 (its generalization): round trips on the C++ host codec, and
    the port's coder (D4 on CUDA) equal to it byte for byte on a 48 KiB
    slice; each coder call's wall time (host clock) beside the host
    codec's on the same slice (``coder_encode_s``, ``host_encode_s``)."""
    data = mixed_buffer(1 << 20, root=(corpora or Corpora()).root)
    nf2 = native.compress(data, k=2)
    nf4 = native.compress(data, k=4)
    _require(native.decompress(nf2, k=2, max_out=len(data) + 16) == data
             and native.decompress(nf4, k=4, max_out=len(data) + 16) == data,
             "config 2: the host codec's round trips")
    sl = data[: 48 << 10]
    coder_s, host_s = {}, {}
    for k in (2, 4):
        t0 = time.perf_counter()
        got = coder_frame(sl, k, device=device)
        t1 = time.perf_counter()
        want = native.compress(sl, k=k)
        t2 = time.perf_counter()
        _require(got == want, f"config 2: k={k} frame mismatch")
        coder_s[f"k{k}"], host_s[f"k{k}"] = t1 - t0, t2 - t1
    return {"config": 2, "workload": "1MiB mixed, k=4 (+k=2 ref-identical)",
            "ratio_k2": len(nf2) / len(data),
            "ratio_k4": len(nf4) / len(data),
            "bit_exact": "k<=2 reference format; coder==native byte-for-byte",
            "corpus_sha256": hashlib.sha256(data).hexdigest(),
            "coder_encode_s": coder_s, "host_encode_s": host_s}


def _on_cuda(device) -> bool:
    return resolve_device(device).type == "cuda"


def config3(device="cuda", corpora=None, size: int = CORPUS_BYTES):
    """enwik8 stand-in: 32 MiB of ``corpus``, 128 KiB blocks, per-block
    tables at the default table-log policy (blocks may differ in L: the
    rate counts those of the first block's), k=1024."""
    corpora = corpora or Corpora()
    data = corpora.get("text", size)
    t0 = time.perf_counter()
    comp = compress(data, **CONFIG3, lanes=True, device=device)
    t_c = time.perf_counter() - t0
    _require(decompress(comp, device=device) == data.tobytes(),
             "config 3: round trip")
    res = {"config": 3, "workload": "32MiB text corpus, 128KiB blocks, k=1024",
           "ratio": len(comp) / len(data), "compress_s_e2e": t_c,
           "corpus_sha256": corpora.sha256("text", size)}
    if _on_cuda(device):
        res.update(_rate_fields(device_decode_gbps(
            comp, CONFIG3["block_size"], CONFIG3["k"], data=data,
            device=device), "device_decode_GBps"))
    return res


def config4(device="cuda", corpora=None, size: int = 64 * MIB):
    """enwik9-on-8-chips stand-in: 64 MiB of ``corpus``, a shared table,
    4 MiB blocks, k=8192, the blocks sharded over ``default_mesh()`` (every
    card; on the CPU one device)."""
    corpora = corpora or Corpora()
    data = corpora.get("text", size)
    mesh = default_mesh() if _on_cuda(device) else (resolve_device(device),)
    sh = block_sharding(mesh)
    comp = compress(data, **CONFIG4, shared_table=True, lanes=True,
                    sharding=sh)
    _require(decompress(comp, sharding=sh) == data.tobytes(),
             "config 4: round trip")
    res = {"config": 4,
           "workload": "64MiB corpus, shared table, mesh-sharded blocks",
           "n_devices": len(mesh), "ratio": len(comp) / len(data),
           "corpus_sha256": corpora.sha256("text", size)}
    if _on_cuda(device):
        res.update(_rate_fields(device_decode_gbps(
            comp, CONFIG4["block_size"], CONFIG4["k"], data=data,
            device=mesh[0]), "device_decode_GBps"))
    return res


def config5(device="cuda", corpora=None):
    """Multi-host pipeline: no pod here; the pipeline itself
    (``parallel.multihost``) runs as real processes over gloo."""
    return {"config": 5, "workload": "Silesia+enwik9, multi-host v5e-16",
            "status": "pod unavailable; the multi-process pipeline runs as "
                      "2 and 4 gloo processes on the CPU "
                      "(tests/test_torch_multihost.py) and as 2 processes "
                      "on the card (chip_smoke.py phase multihost), each "
                      "frame byte-identical to the single-process one"}


CONFIG6_CORPORA = {"geo(bench)": "geo", "text": "text", "bf16": "bf16",
                   "jsonlog": "jsonlog", "mixed": "mixed"}


def config6(device="cuda", corpora=None, size: int = CORPUS_BYTES):
    """Ratio per corpus at the two shipping operating points: the
    throughput point (16 MiB blocks, k=16384, L=8) and the size-parity
    point (k=8192, L=11, bit-packed); on CUDA, B1's rate on each
    throughput frame. 32 MiB per corpus."""
    corpora = corpora or Corpora()
    rows = {}
    for name, key in CONFIG6_CORPORA.items():
        data = corpora.get(key, size)
        c_thr = compress(data, **THROUGHPUT, lanes=True, device=device)
        c_par = compress(data, **PARITY, lanes=True, device=device)
        _require(decompress(c_thr, device=device) == data.tobytes()
                 and decompress(c_par, device=device) == data.tobytes(),
                 f"config 6 ({name}): round trip")
        row = {"ratio_throughput_L8": len(c_thr) / size,
               "ratio_parity_L11_packed": len(c_par) / size,
               "sha256": corpora.sha256(key, size)}
        if _on_cuda(device):
            row.update(_rate_fields(device_decode_gbps(
                c_thr, THROUGHPUT["block_size"], THROUGHPUT["k"], data=data,
                device=device), "device_decode_GBps_L8"))
        rows[name] = row
    return {"config": 6, "workload": "corpus diversity, 32MiB each",
            "corpora": rows}


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5,
           6: config6}


def run(which=tuple(CONFIGS), device="cuda", corpora=None, out=print):
    """Configs ``which`` in turn on ``device``, sharing one ``Corpora``;
    ``out`` takes each result's JSON line. Returns the results."""
    corpora = corpora or Corpora()
    results = []
    for i in which:
        t0 = time.perf_counter()
        res = CONFIGS[i](device, corpora)
        res["wall_s"] = time.perf_counter() - t0
        out(json.dumps(res))
        results.append(res)
    return results


def main(argv) -> int:
    from ..kernels.build import load

    resolve_device("cuda")  # raises without CUDA
    load()  # the kernels' build is no config's time
    run([int(x) for x in argv[1:]] or tuple(CONFIGS),
        out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

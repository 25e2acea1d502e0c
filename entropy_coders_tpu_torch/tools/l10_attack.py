"""Decode table-layout experiments at the bench shape (runs kernel B4).

Counterpart of the JAX package's ``tools/l10_attack.py``. It compresses the
bench corpus (``gen_sequence(0.2)``, 128 MiB) with the port's ``compress``
at 16 MiB blocks, k=16384 and table log L, splits the lanes of the frame,
and decodes every block with B1 (``base``) and with each layout of
``l10_attack_harness`` that applies at L:

  flat   B1's own 4-byte entry through the layout kernel (the control);
  split  3-byte entries (L <= 12);
  upack  2-byte entries (only where ``upack_ok``);
  fused  one 4-byte word, sym << (L + 4) | nb << L | base;
  nosym  the (nb, base) plane alone: wrong bytes by design, the bound for
         any layout that still fetches (nb, base) (L <= 12).

Every layout but ``nosym`` must give B1's symbols and the input bytes, and
every cursor must end at 0. On a CUDA device each decode is timed with CUDA
events over all blocks (ms, the median of 14 runs taken in two passes in
opposite orders; GB/s of raw bytes) beside its instantiation's co-resident
CTAs per SM; on the CPU (the plain versions, for tests) nothing is timed.

The JAX tool's ``e2`` variant (``l10_attack.py:78-80``, B1 at an epoch
unroll E=2) is not ported: epochs are a TPU schedule, and the kernel here
has none.

Usage, on a machine with a CUDA device:

    python -m entropy_coders_tpu_torch.tools.l10_attack [L]     # default 10
"""

from __future__ import annotations

import statistics
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..frame import compress
from ..ops import pl_coder as PL
from ..ops.unsigned import to_device
from . import l10_attack_harness as H
from .bench_data import cuda_ms, gen_sequence, parse_pl_frame

MIB = 1 << 20
BLOCK = 16 * MIB
K = 16384


class LaneInputs(NamedTuple):
    """A frame's lanes on one device, ready for the decode kernels."""
    data: np.ndarray         # the raw bytes (full blocks)
    frame: bytes             # the port's MODE_FSE_PL frame of ``data``
    words: torch.Tensor      # (B, W, k) uint32 lane words
    sizes: torch.Tensor      # (B, k) int32 lane sizes in bits
    dec: torch.Tensor        # (B, 2^L) uint32 flat decode tables
    norm_tables: np.ndarray  # (B, 256) int32
    L: int
    R: int


def lane_inputs(data: np.ndarray, L: int, *, block_size: int = BLOCK,
                k: int = K, device="cuda") -> LaneInputs:
    """Compress ``data`` (whole blocks) at table log ``L`` on ``device`` and
    lay its lanes out as B1 takes them (the JAX tool's parse and
    ``lane_split_batch``)."""
    if len(data) == 0 or len(data) % block_size:
        raise ValueError(f"{len(data)} bytes are not whole {block_size}-byte "
                         "blocks")
    frame = compress(data, block_size=block_size, k=k, lanes=True,
                     table_log=L, device=device)
    sizes, payloads, nt, L2, packed = parse_pl_frame(frame, block_size, k)
    if L2 != L:
        raise ValueError(f"the frame has table log {L2}, not {L}")
    W = -(-(int(sizes.max()) // 32 + 3) // 16) * 16
    words = PL.lane_split_batch(payloads, sizes, k, W, pack_bits=packed)
    dev = torch.device(device)
    return LaneInputs(data, frame, to_device(words, dev),
                      torch.from_numpy(sizes).to(dev),
                      PL.tables_from_norm(nt, L, dev).dec, nt, L,
                      block_size // k - 1)


def _require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def run_layouts(inp: LaneInputs, layouts=H.LAYOUTS) -> dict:
    """Decode ``inp`` with B1 and each of ``layouts`` that applies; check
    them (module docstring) and, on a CUDA device, time them. Returns
    {name: {...}} with ``base`` for B1; prints one line per decode."""
    words, sizes, dec, L, R = inp.words, inp.sizes, inp.dec, inp.L, inp.R
    B, _, k = words.shape
    dev = words.device
    timed = dev.type == "cuda"
    raw = B * (R + 1) * k
    want = torch.from_numpy(inp.data).to(dev).reshape(B, R + 1, k)
    tag = f"L={L} B={B}"

    base = PL.decode_lanes(words, sizes, dec, L=L, R=R)
    _require(not bool(base[2].any()), f"{tag} base: a cursor did not drain")
    _require(torch.equal(base[0], want[:, :R])
             and torch.equal(base[1], want[:, R]),
             f"{tag} base: decoded bytes differ from the input")
    calls = {"base": (lambda: PL.decode_lanes(words, sizes, dec, L=L, R=R),
                      H.table_bytes("flat", L), None)}
    out, skipped = {}, {}
    for name in layouts:
        if not H.layout_applies(name, inp.norm_tables, L):
            skipped[name] = {"eligible": False}
            print(f"{tag} {name}: does not apply (max count "
                  f"{int(inp.norm_tables.max())})", flush=True)
            continue
        table = H.layout_tables(dec, L, name)
        syms, finals, cur = H.decode_lanes_layout(words, sizes, table,
                                                  layout=name, L=L, R=R)
        _require(not bool(cur.any()), f"{tag} {name}: a cursor did not drain")
        if name != "nosym":
            _require(torch.equal(syms, base[0])
                     and torch.equal(finals, base[1]),
                     f"{tag} {name}: symbols differ from B1's")
            _require(torch.equal(syms, want[:, :R])
                     and torch.equal(finals, want[:, R]),
                     f"{tag} {name}: decoded bytes differ from the input")
        calls[name] = (lambda t=table, n=name: H.decode_lanes_layout(
            words, sizes, t, layout=n, L=L, R=R), H.table_bytes(name, L),
            H.layout_occupancy(name, L, dev, k) if timed else None)
    # timed in turns, forward then backward, so that no decode gains from
    # its place in the order (clocks ramping up, caches warming)
    runs = {name: [] for name in calls}
    for order in ((list(calls), list(calls)[::-1]) if timed else ()):
        for name in order:
            runs[name] += cuda_ms(calls[name][0])[1]
    for name, (_, smem, ctas) in calls.items():
        res = {"eligible": True, "table_bytes": smem}
        if timed:
            ms = statistics.median(runs[name])
            res.update(ms=ms, runs=runs[name], GBps=raw / ms / 1e6)
            if ctas is not None:
                res["ctas_per_sm"] = ctas
            print(f"{tag} {name}: {ms:.4f} ms = {res['GBps']:.1f} GB/s "
                  f"({smem} B of table per CTA"
                  + (f", {ctas} CTAs/SM)" if ctas is not None else ")"),
                  flush=True)
        else:
            print(f"{tag} {name}: checked on {dev} (not timed)", flush=True)
        out[name] = res
    return {**out, **skipped}


def run(L: int = 10, size: int = 128 * MIB, device="cuda", *,
        block_size: int = BLOCK, k: int = K) -> dict:
    """B1 and every layout that applies at ``L`` on ``size`` bytes of the
    bench corpus (defaults: the bench shape)."""
    data = gen_sequence(0.2, size)
    return run_layouts(lane_inputs(data, L, block_size=block_size, k=k,
                                   device=device))


def main(argv) -> int:
    run(int(argv[1]) if len(argv) > 1 else 10)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

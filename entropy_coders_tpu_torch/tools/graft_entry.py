"""The root ``__graft_entry__.py`` on the port: a one-block device round
trip (``entry``) and a dry run over a mesh (``dryrun_multichip``).

* ``entry(device)`` returns ``(fn, args)``: ``fn`` is one block's round
  trip, k-way tANS encode, bit-pack and k-way decode, through the port's
  shared-stream cores ``ops.coder.encode_core`` and ``decode_core``
  (kernels D4 and D5 on the card, their plain versions on the CPU), on
  the tiny block of ``example_block``. It returns ``(out_syms, emit_count,
  finals, done)``, equal to the JAX function's; there is no ``jit``. Like
  the JAX function it starts the decode one bit past the stream's marker
  bit, so those outputs are not the block's bytes; ``block_roundtrip``
  starts it at the marker and gives the bytes back.
* ``dryrun_multichip(n, device)`` runs the JAX function's five checks over
  a mesh of n devices: the sharded histogram sums to the input's length,
  and four sharded round trips (per-block tables; ``shared_table``;
  per-lane streams at k=128; the same bit-packed, whose frame must be
  smaller). On CUDA the mesh is ``parallel.default_mesh(n)``; ``mesh=``
  gives another, such as ``(torch.device("cpu"),) * n`` or virtual ranks
  of one card. It returns the four frames.

Usage, on a machine with a CUDA device (the dry run over every card):

    python -m entropy_coders_tpu_torch.tools.graft_entry [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import native
from ..frame import compress, decompress
from ..normalize import normalize_batch
from ..ops.coder import blocks_to_syms, decode_core, encode_core, encode_layout
from ..ops.unsigned import resolve_device, to_device
from ..parallel import block_sharding, default_mesh, sharded_histogram


def _require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def example_block(n: int = 4096, k: int = 64, seed: int = 7,
                  device="cuda"):
    """A tiny prepared block on ``device``: (args, meta). ``args`` are the
    block's symbols in emission order (R, k), the emission mask, the init
    symbols (k,), the final-state slot order, and its tables (``tt_bits``,
    ``tt_fs``, the encode ``table``, the packed decode entries) at the
    reference's optimal table log, built by the port's host library;
    ``meta`` holds n, k, L, W, the decode's R, m and the data."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = (rng.integers(0, 64, n, dtype=np.uint16) ** 2 % 251).astype(
        np.uint8)
    norm, log2s = normalize_batch(np.bincount(data, minlength=256)[None], n,
                                  "auto")
    L = int(log2s[0])
    table, tt_bits, tt_fs = native.build_encode_tables(norm, L)
    packed = native.build_decode_tables(norm, L)
    m, R, valid, finish_slots, W = encode_layout(n, k)
    syms, init_syms = blocks_to_syms(data[None], m, R, k)
    args = (torch.from_numpy(np.ascontiguousarray(syms[0])).to(dev),
            torch.from_numpy(valid).to(dev),
            torch.from_numpy(init_syms[0]).to(dev),
            torch.from_numpy(finish_slots).to(dev),
            to_device(tt_bits[0], dev), to_device(tt_fs[0], dev),
            to_device(table[0], dev), to_device(packed[0], dev))
    meta = dict(n=n, k=k, L=L, W=W, R=R + 1, m=m, data=data)
    return args, meta


def _roundtrip_step(meta: dict, back: int):
    """One block's encode then decode through the shared-stream cores; the
    decode starts ``back`` bits below the encode's ``total_bits``."""
    k, L, W, R = meta["k"], meta["L"], meta["W"], meta["R"]

    def roundtrip_step(syms, valid, init_syms, finish_slots, tt_bits, tt_fs,
                       table, packed):
        words, total_bits = encode_core(
            syms[None], valid, init_syms[None], finish_slots,
            (table[None], tt_bits[None], tt_fs[None]), k=k, L=L, W=W)
        out_syms, emit_count, finals, done, _ = decode_core(
            words, total_bits - back, packed[None], k=k, L=L, R=R)
        return out_syms[0], emit_count[0], finals[0], done[0]

    return roundtrip_step


def entry(device="cuda"):
    """(fn, example_args): one block's full device round trip (k-way tANS
    encode, bit-pack, k-way decode) on ``example_block``, the decode
    started at ``total_bits`` as the JAX function starts it."""
    args, meta = example_block(device=device)
    return _roundtrip_step(meta, 0), args


def block_roundtrip(device="cuda") -> bytes:
    """``example_block``'s bytes through ``entry``'s cores with the decode
    started at the marker bit (``total_bits - 1``, as
    ``ops.coder.decode_interleaved`` starts it), laid out as that function
    lays them out: the emitted symbols, then the finals. Raises
    RuntimeError when the decode does not finish."""
    args, meta = example_block(device=device)
    out_syms, emit_count, finals, done = _roundtrip_step(meta, 1)(*args)
    _require(bool(done), "entry: the decode did not finish")
    flat = out_syms.reshape(-1)[: int(emit_count)]
    return torch.cat([flat, finals]).cpu().numpy().tobytes()


DRYRUN_BLOCK = 2048
# the dry run's four sharded round trips, each a frame's knobs
DRYRUN_FRAMES = (("plain", dict(k=16)),
                 ("shared", dict(k=16, shared_table=True)),
                 ("lanes", dict(k=128, lanes=True)),
                 ("packed", dict(k=128, lanes=True, bit_pack=True)))


def dryrun_data(n_devices: int) -> np.ndarray:
    """The dry run's input: two tiny blocks a device."""
    rng = np.random.default_rng(0)
    return (rng.integers(0, 32, 2 * n_devices * DRYRUN_BLOCK,
                         dtype=np.uint16) ** 2 % 249).astype(np.uint8)


def dryrun_multichip(n_devices: int, device="cuda", mesh=None) -> dict:
    """The full block-parallel path over a mesh of ``n_devices`` (blocks
    split over it, the shared table's histogram summed across it) on tiny
    shapes, every round trip checked (RuntimeError otherwise). The mesh is
    ``mesh`` when given, else ``default_mesh(n_devices)`` on CUDA and
    ``device`` repeated ``n_devices`` times elsewhere. Returns the frames
    of ``DRYRUN_FRAMES``: ``plain``, ``shared``, ``lanes`` and ``packed``.
    ``plain`` and ``shared`` leave ``lanes`` unset, so their table log is
    the device's default, as in the JAX function: ``PL_TABLE_LOG`` on a
    CUDA mesh, ``TABLE_LOG_DEFAULT`` on the CPU."""
    if mesh is None:
        dev = resolve_device(device)
        mesh = (default_mesh(n_devices) if dev.type == "cuda"
                else (dev,) * n_devices)
    _require(len(mesh) == n_devices,
             f"need {n_devices} devices, have {len(mesh)}")
    sh = block_sharding(mesh)

    data = dryrun_data(n_devices)
    # the shared histogram, summed over the blocks split across the mesh
    counts = sharded_histogram(data.reshape(-1, DRYRUN_BLOCK), mesh)
    _require(int(counts.sum()) == len(data),
             "multichip dryrun: the sharded histogram's sum")

    frames = {}
    for name, kw in DRYRUN_FRAMES:
        frames[name] = compress(data, block_size=DRYRUN_BLOCK, sharding=sh,
                                **kw)
        _require(decompress(frames[name], sharding=sh) == data.tobytes(),
                 f"multichip dryrun: the {name} round trip failed")
    _require(len(frames["packed"]) < len(frames["lanes"]),
             "multichip dryrun: the bit-packed frame is not smaller")
    return frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m entropy_coders_tpu_torch.tools.graft_entry",
        description="One block's device round trip, then the dry run over "
                    "every card.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without CUDA) or cpu (the "
                         "plain versions, a mesh of one CPU device)")
    dev = resolve_device(ap.parse_args(argv).device)
    fn, args = entry(dev)
    res = fn(*args)
    _require(block_roundtrip(dev) == example_block(device="cpu")[1][
        "data"].tobytes(), "entry: the block's round trip failed")
    print("entry() compile+run OK:", [tuple(r.shape) for r in res])
    dryrun_multichip(torch.cuda.device_count() if dev.type == "cuda" else 1,
                     dev)
    print("dryrun_multichip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Block-parallel compression over a mesh of devices.

Counterpart of ``entropy_coders_tpu/parallel/sharding.py``. Blocks are
independent, so the scaling story is data parallelism over them: each mesh
entry histograms, encodes and decodes its own contiguous share of a group's
blocks, with no communication in the coding itself (``frame.compress`` and
``frame.decompress`` with ``sharding=``). Every share's work is queued on
its own device before the host waits for any, so the cards of a mesh work
at once; the host then gathers the variable-length sections in block
order.

A mesh is a tuple of ``torch.device``; a device may repeat. A mesh that
names one card several times (virtual ranks) is the port's counterpart of
the JAX suite's virtual CPU devices: ``(torch.device("cuda", 0),) * 8``
runs eight ranks on one H100, ``(torch.device("cpu"),) * 8`` runs them on
the CPU with the kernels' plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import frame as F
from ..ops.histogram import histogram_blocks
from ..ops.unsigned import to_device


@dataclass(frozen=True)
class BlockSharding:
    """Blocks split over ``mesh`` (the counterpart of the JAX package's
    ``NamedSharding(mesh, P("blocks"))``)."""
    mesh: tuple[torch.device, ...]


def default_mesh(n_devices: int | None = None) -> tuple[torch.device, ...]:
    """The first ``n_devices`` CUDA devices (all of them by default).

    The shares run on their cards at once, but the host's per-block work
    (section assembly, the frame's join; on decompress the parse, the
    write-back, the crc and the final copy) does not shrink with the
    cards, and it takes most of a call. On four NVIDIA H100 80GB HBM3 at
    700 W the 128 MiB throughput point compressed in 46 ms against 60 ms
    on one of them (decompress 137 / 136 ms), and 1 GiB in config 4's
    shape (BASELINE.md) in 0.79 s against 0.86 s (decompress 1.44 /
    1.51 s); ``chip_smoke.py`` phase ``sharded``, medians of three in
    turns."""
    if not torch.cuda.is_available():
        raise RuntimeError("default_mesh needs CUDA; pass a mesh such as "
                           "(torch.device('cpu'),) * 8 for the plain versions")
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    return devs if n_devices is None else devs[:n_devices]


def block_sharding(mesh) -> BlockSharding:
    return BlockSharding(tuple(torch.device(d) for d in mesh))


def compress(data, mesh=None, **kwargs) -> bytes:
    """Frame-compress ``data`` with blocks spread over ``mesh`` (default:
    every CUDA device), every share's kernels queued on its own device
    before any is drained. Accepts every single-device keyword. The bytes
    equal ``frame.compress``'s; what the cards save is bounded by the
    host's part of the call (see ``default_mesh``)."""
    mesh = mesh or default_mesh()
    return F.compress(data, sharding=block_sharding(mesh), **kwargs)


def decompress(frame: bytes, mesh=None, **kwargs):
    """Decompress with blocks spread over ``mesh``, every share of every
    table-log group queued on its own device before any is drained.
    Accepts every single-device keyword (``start``/``length`` range
    decode, ``out``, ...) and passes it through."""
    mesh = mesh or default_mesh()
    return F.decompress(frame, sharding=block_sharding(mesh), **kwargs)


def sharded_histogram(blocks, mesh) -> torch.Tensor:
    """Byte histogram of ``blocks`` (B, n) uint8, blocks split over
    ``mesh``: per-block counts on each rank's device, one D6 launch a share
    (``ops.histogram.histogram_blocks``, the plain version on the CPU),
    every share queued before any is summed, then one exact sum on
    ``mesh[0]`` (the counterpart of the JAX function's XLA all-reduce;
    plain torch, not the ring). Returns (256,) int64 counts on
    ``mesh[0]``: exact where the JAX function's uint32 sum wraps at 4
    GiB."""
    mesh = F._mesh_devices(mesh)
    blocks = np.asarray(blocks, np.uint8)
    pinned = F._spans_cards(mesh)
    parts = [histogram_blocks(to_device(blocks[lo:hi], dev,
                                        non_blocking=pinned)).sum(dim=0)
             for dev, lo, hi in F._shares(blocks.shape[0], mesh)]
    if not parts:
        return torch.zeros(256, dtype=torch.int64, device=mesh[0])
    return torch.stack([p.to(mesh[0]) for p in parts]).sum(dim=0)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, **kwargs) -> None:
    """Initialise the multi-process runtime: see ``parallel.multihost`` for
    the per-process compress/assemble/decompress pipeline."""
    from .multihost import init_distributed as _init

    _init(coordinator_address, num_processes, process_id, **kwargs)

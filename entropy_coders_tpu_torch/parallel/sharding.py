"""Block-parallel compression over a mesh of devices.

Counterpart of ``entropy_coders_tpu/parallel/sharding.py``. Blocks are
independent, so the scaling story is data parallelism over them: each mesh
entry histograms, encodes and decodes its own contiguous share of a group's
blocks, with no communication in the coding itself (``frame.compress`` and
``frame.decompress`` with ``sharding=``). The host gathers the
variable-length sections in block order.

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


@dataclass(frozen=True)
class BlockSharding:
    """Blocks split over ``mesh`` (the counterpart of the JAX package's
    ``NamedSharding(mesh, P("blocks"))``)."""
    mesh: tuple[torch.device, ...]


def default_mesh(n_devices: int | None = None) -> tuple[torch.device, ...]:
    """The first ``n_devices`` CUDA devices (all of them by default).

    The shares of a mesh still run one after the other, so a mesh of
    several cards is not yet faster than one card (on four H100s the
    128 MiB throughput point compresses slower than on one)."""
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
    every CUDA device). Accepts every single-device keyword. The bytes
    equal ``frame.compress``'s; the time does not yet drop with more
    devices (see ``default_mesh``)."""
    mesh = mesh or default_mesh()
    return F.compress(data, sharding=block_sharding(mesh), **kwargs)


def decompress(frame: bytes, mesh=None, **kwargs):
    """Decompress with blocks spread over ``mesh``. Accepts every
    single-device keyword (``start``/``length`` range decode, ``out``, ...)
    and passes it through."""
    mesh = mesh or default_mesh()
    return F.decompress(frame, sharding=block_sharding(mesh), **kwargs)


def sharded_histogram(blocks, mesh) -> torch.Tensor:
    """Byte histogram of ``blocks`` (B, n) uint8, blocks split over
    ``mesh``: per-block counts on each rank's device, then an exact sum
    across the devices (the counterpart of the JAX function's XLA
    all-reduce; plain torch, not the ring). Returns (256,) int64 counts on
    ``mesh[0]``: exact where the JAX function's uint32 sum wraps at 4 GiB."""
    mesh = F._mesh_devices(mesh)
    blocks = np.asarray(blocks, np.uint8)
    total = torch.zeros(256, dtype=torch.int64, device=mesh[0])
    for dev, lo, hi in F._shares(blocks.shape[0], mesh):
        part = histogram_blocks(torch.from_numpy(blocks[lo:hi]).to(dev))
        total += part.sum(dim=0).to(mesh[0])
    return total


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, **kwargs) -> None:
    """Initialise the multi-process runtime: see ``parallel.multihost`` for
    the per-process compress/assemble/decompress pipeline."""
    from .multihost import init_distributed as _init

    _init(coordinator_address, num_processes, process_id, **kwargs)

"""Multi-device and multi-process parallelism (meshes of torch devices)."""

from . import multihost, rdma
from .sharding import (block_sharding, compress, decompress, default_mesh,
                       init_distributed, sharded_histogram)

__all__ = [
    "block_sharding",
    "compress",
    "decompress",
    "default_mesh",
    "init_distributed",
    "multihost",
    "rdma",
    "sharded_histogram",
]

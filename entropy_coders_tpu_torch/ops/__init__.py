"""Compute path of the port: per-lane kernels and their plain versions
(``pl_coder``, which also holds the JAX package's public lane entries
``decode_lanes``, ``encode_lanes`` and ``encode_w_bound``), the lane
repack and the table build on the device (``device_repack``, ``tables``),
the shared-stream kernels' wrappers and plain versions and the
reference-format payload codec (``coder``) and the byte histograms'
kernel wrapper and plain version (``histogram``)."""

from .coder import decode_interleaved, encode_interleaved
from .pl_coder import decode_lanes, encode_lanes, encode_w_bound

__all__ = [
    "decode_interleaved",
    "encode_interleaved",
    "decode_lanes",
    "encode_lanes",
    "encode_w_bound",
]

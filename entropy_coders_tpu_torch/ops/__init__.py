"""Compute path of the port: per-lane kernels and their plain versions
(``pl_coder``), the lane repack and the table build on the device
(``device_repack``, ``tables``), the shared-stream cores and the
reference-format payload codec (``coder``) and the per-block histogram
(``histogram``)."""

from .coder import decode_interleaved, encode_interleaved

__all__ = ["decode_interleaved", "encode_interleaved"]

"""Compute path of the port: per-lane kernels and their plain versions
(``pl_coder``), the shared-stream cores (``coder``) and the per-block
histogram (``histogram``)."""

"""Measurement tools of the port: the decode table-layout harness, the
per-lane kernels at their launch shapes (``lane_shapes``) and the lane
repack and table build on the card (``device_host``).

Counterparts of the JAX package's ``tools/l10_attack.py``,
``tools/l10_attack_harness.py``, ``tools/upack_l10.py`` and
``tools/upack_hilog.py``:

* ``bench_data``         — the bench corpus, frame parsing, a CUDA timer;
* ``l10_attack_harness`` — ``decode_lanes_layout``: B1's lane decode with a
  pluggable table entry format (kernel ``csrc/pl_decode_layout.cu``);
* ``l10_attack``, ``upack_l10``, ``upack_hilog`` — the scripts, each run as
  ``python -m entropy_coders_tpu_torch.tools.<name> [L]`` on a CUDA machine;
* ``device_host``        — kernels D1-D3 (``csrc/repack.cu``,
  ``csrc/tables.cu``) against their plain versions and the C++ host
  library, and timed beside the C++ calls.

Importing a module runs no work.
"""

"""Measurement tools of the port: the decode table-layout harness, the
per-lane kernels at their launch shapes (``lane_shapes``), the lane
repack and table build on the card (``device_host``), and the root
scripts' corpora, configs and table-log policy sweep.

Counterparts of the JAX repository's ``tools/l10_attack.py``,
``tools/l10_attack_harness.py``, ``tools/upack_l10.py``,
``tools/upack_hilog.py`` and the root ``bench_configs.py``,
``policy_sweep.py``, ``bench.py`` and ``__graft_entry__.py``:

* ``bench_data``         — the bench corpus, frame parsing (every block, or
  the blocks the JAX decode-rate helper selects), a CUDA timer;
* ``l10_attack_harness`` — ``decode_lanes_layout``: B1's lane decode with a
  pluggable table entry format (kernel ``csrc/pl_decode_layout.cu``);
* ``l10_attack``, ``upack_l10``, ``upack_hilog`` — the scripts, each run as
  ``python -m entropy_coders_tpu_torch.tools.<name> [L]`` on a CUDA machine;
* ``bench_configs``      — the stand-in corpora (the text ones read the
  checkout's root files), BASELINE configs 1-6, B1's decode-rate timer
  ``device_decode_gbps`` and B2's encode-rate timer ``device_encode_gbps``:
  ``python -m ...tools.bench_configs [1..6]``;
* ``policy_sweep``       — B1's rate per table log and each table-log
  policy's ratio, chosen logs and effective rate per corpus:
  ``python -m ...tools.policy_sweep``;
* ``bench``              — the root ``bench.py``'s two JSON lines: B1's and
  B2's device-resident rates and the round trips at the throughput and
  parity points:
  ``python -m ...tools.bench [--device cuda|cpu]``;
* ``graft_entry``        — one block's round trip through the
  shared-stream cores (``entry``) and the mesh dry run
  (``dryrun_multichip``): ``python -m ...tools.graft_entry``;
* ``device_host``        — kernels D1-D3 (``csrc/repack.cu``,
  ``csrc/tables.cu``) against their plain versions and the C++ host
  library, and timed beside the C++ calls.

Importing a module runs no work.
"""

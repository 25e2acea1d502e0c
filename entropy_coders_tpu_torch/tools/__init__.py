"""Measurement tools of the port: the decode table-layout harness.

Counterparts of the JAX package's ``tools/l10_attack.py``,
``tools/l10_attack_harness.py``, ``tools/upack_l10.py`` and
``tools/upack_hilog.py``:

* ``bench_data``         — the bench corpus, frame parsing, a CUDA timer;
* ``l10_attack_harness`` — ``decode_lanes_layout``: B1's lane decode with a
  pluggable table entry format (kernel ``csrc/pl_decode_layout.cu``);
* ``l10_attack``, ``upack_l10``, ``upack_hilog`` — the scripts, each run as
  ``python -m entropy_coders_tpu_torch.tools.<name> [L]`` on a CUDA machine.

Importing a module runs no work.
"""

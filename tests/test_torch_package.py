"""The port imports torch and never jax: a fresh interpreter that imports
entropy_coders_tpu_torch (and its parallel package) and round-trips a frame
on the CPU, sharded and not, must not have loaded jax (the machine with the
card has none)."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import numpy as np
import torch
import entropy_coders_tpu_torch as T
from entropy_coders_tpu_torch import parallel as P
from entropy_coders_tpu_torch.kernels import build
data = (np.arange(20000) % 7 * 13 % 256).astype(np.uint8)
mesh = (torch.device("cpu"),) * 3
for lanes in (True, False):
    frame = T.compress(data, block_size=4096, k=128, lanes=lanes,
                       device="cpu")
    assert T.decompress(frame, device="cpu") == data.tobytes()
    assert P.compress(data, mesh, block_size=4096, k=128,
                      lanes=lanes) == frame
    assert P.decompress(frame, mesh) == data.tobytes()
x = np.arange(3 * 256, dtype=np.int32).reshape(3, 256)
assert (P.rdma.ring_all_reduce_histograms(x, mesh).numpy()
        == x.sum(0)).all()
assert P.multihost.owned_blocks(5) == (0, 5)
assert T.__version__
mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print("JAX_MODULES", mods)
"""


def test_port_never_imports_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "JAX_MODULES []" in r.stdout, r.stdout

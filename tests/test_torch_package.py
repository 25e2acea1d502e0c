"""The port imports torch and never jax: a fresh interpreter that imports
entropy_coders_tpu_torch (and its parallel, tools and utils packages, its
stream, checkpoint and CLI modules), round-trips a frame on the CPU,
sharded and not and on the device-repack route, builds tables with
``ops.tables``, merges lanes with ``ops.device_repack``, decodes a frame
with the layout harness and with the JAX-signature ``ops.decode_lanes``,
counts bytes with ``ops.histogram.histogram_u8``, streams a file,
round-trips a checkpoint and an interleaved payload (its tables from the
port's own host library), builds the config tool's corpora (bf16 through
torch, without ``ml_dtypes``) and a policy's chosen logs, and imports the
bench and the graft entry and round-trips the graft entry's block must not
have loaded jax (the machine with the
card has none). The JAX package is blocked in ``sys.modules`` before the
port is imported, so any import of it fails the probe.

The sources the port builds at first use (its CUDA kernels, the headers
they include, its C++ host library) must be package data in
``pyproject.toml``, or an installed package cannot build them."""

import fnmatch
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
sys.modules["entropy_coders_tpu"] = None  # any import of it now fails
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
from entropy_coders_tpu_torch import tools
from entropy_coders_tpu_torch.tools import (bench_data, l10_attack,
                                            l10_attack_harness as H,
                                            upack_hilog, upack_l10)
from entropy_coders_tpu_torch.ops import pl_coder as PL
from entropy_coders_tpu_torch.ops.unsigned import to_device
blocks = bench_data.gen_sequence(0.2, 2 * 4096)
frame = T.compress(blocks, block_size=4096, k=128, lanes=True, table_log=9,
                   device="cpu")
sizes, payloads, nt, L, packed = bench_data.parse_pl_frame(frame, 4096, 128)
words = to_device(PL.lane_split_batch(payloads, sizes, 128, 32), "cpu")
dec = PL.tables_from_norm(nt, L, "cpu").dec
syms, finals, cur = H.decode_lanes_layout(
    words, torch.from_numpy(sizes), H.layout_tables(dec, L, "upack"),
    layout="upack", L=L, R=31)
assert not cur.any() and (finals.numpy() == blocks.reshape(2, 32, 128)[:, 31]).all()
from entropy_coders_tpu_torch import ops
from entropy_coders_tpu_torch.ops.histogram import histogram_u8
syms2, finals2 = ops.decode_lanes(words, sizes, dec, k=128, L=L, R=31,
                                  device="cpu")
assert torch.equal(finals2, finals) and torch.equal(syms2, syms)
assert int(histogram_u8(blocks, device="cpu").sum()) == len(blocks)
assert H.LAYOUT_LAUNCHES == dict.fromkeys(H.LAYOUTS, 0)
assert T.__version__
from entropy_coders_tpu_torch import builddir, frame as TF
from entropy_coders_tpu_torch.ops import device_repack as DR, tables as TB
from entropy_coders_tpu_torch.tools import device_host
host = PL.tables_from_norm(nt, L, "cpu", host_tables=True)
dev = PL.tables_from_norm(nt, L, "cpu", host_tables=False)
assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
           for a, b in zip(host, dev))
assert torch.equal(TB.build_decode_table(torch.from_numpy(nt), log2=L).view(
    torch.uint8), host.dec.view(torch.uint8))
flat, offs = DR.lane_merge_device(words, torch.from_numpy(sizes),
                                  pack_bits=packed)
assert [bytes(flat[offs[b]: offs[b + 1]].numpy()) for b in range(2)] == [
    bytes(p) for p in payloads]
TF._DEVICE_REPACK = True  # the container's device-repack route, on the CPU
assert T.compress(blocks, block_size=4096, k=128, lanes=True, table_log=9,
                  device="cpu") == frame
assert T.decompress(frame, device="cpu") == blocks.tobytes()
TF._DEVICE_REPACK = None
assert (DR.MERGE_LAUNCHES, DR.SPLIT_LAUNCHES, TB.TABLE_LAUNCHES) == (0, 0, 0)
assert builddir.build_dir().name == "entropy_coders_tpu_torch"
import os, tempfile
from types import SimpleNamespace
from entropy_coders_tpu_torch import native
from entropy_coders_tpu_torch import __main__ as cli
from entropy_coders_tpu_torch import checkpoint, stream, utils
from entropy_coders_tpu_torch.ops import decode_interleaved, encode_interleaved
from entropy_coders_tpu_torch.utils import checked
with tempfile.TemporaryDirectory() as td:
    src, dst, back = (os.path.join(td, f) for f in ("a", "b", "c"))
    open(src, "wb").write(data.tobytes())
    stream.compress_file(src, dst, block_size=4096, k=128, chunk_blocks=2,
                         device="cpu")
    assert utils.frame_stats(open(dst, "rb").read()).n_blocks == 5
    stream.decompress_file(dst, back, device="cpu")
    assert open(back, "rb").read() == data.tobytes()
    tree = {"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
            "n": [np.arange(5, dtype=np.int8), None]}
    checkpoint.save_pytree(dst, tree, block_size=4096, k=128, device="cpu")
    got = checkpoint.load_pytree(dst, device="cpu")
    assert torch.equal(got["w"], tree["w"]) and got["n"][1] is None
    assert (got["n"][0].numpy() == tree["n"][0]).all()
nt, l2 = native.normalize(np.bincount(data[:3000], minlength=256), 3000)
table, tt_bits, tt_fs = native.build_encode_tables(nt[None], l2)
enc = SimpleNamespace(table=table[0], tt_bits=tt_bits[0],
                      tt_find_state=tt_fs[0])
dec = SimpleNamespace(packed=native.build_decode_tables(nt[None], l2)[0])
payload, _ = encode_interleaved(data[:3000], 4, enc, l2, device="cpu")
assert decode_interleaved(payload, 4, dec, l2, 3000,
                          device="cpu") == data[:3000].tobytes()
assert checked.checked_encode_interleaved(
    data[:3000], 4, enc, l2, device="cpu")[0] == payload
assert cli._parse_table_log("fast:0.5") == ("fast", 0.5)
from entropy_coders_tpu_torch.tools import bench_configs, policy_sweep
corpora = bench_configs.Corpora()
assert len(bench_configs.bf16_tensor_bytes(5000)) == 5000
assert "ml_dtypes" not in sys.modules  # bf16 through torch
assert corpora.get("text", 3000).size == 3000
assert len(policy_sweep.chosen_logs(corpora.get("geo", 8192),
                                    {"block_size": 4096, "k": 128},
                                    "auto")) == 2
from entropy_coders_tpu_torch.tools import bench, graft_entry
assert bench.card_name(torch.device("cpu")) == "cpu"
assert graft_entry.block_roundtrip("cpu") == graft_entry.example_block(
    device="cpu")[1]["data"].tobytes()
mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or (m.startswith("entropy_coders_tpu") and sys.modules[m]
                  and not m.startswith("entropy_coders_tpu_torch")))
print("JAX_MODULES", mods)
"""


def test_port_never_imports_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "JAX_MODULES []" in r.stdout, r.stdout


PORT = ROOT / "entropy_coders_tpu_torch"


def _shipped(path: Path) -> bool:
    """Whether ``path`` matches a package-data glob of a package holding it."""
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    for pkg, globs in data["tool"]["setuptools"]["package-data"].items():
        root = ROOT / pkg.replace(".", "/")
        if root in path.parents:
            rel = path.relative_to(root).as_posix()
            if any(fnmatch.fnmatch(rel, g) for g in globs):
                return True
    return False


def _built_sources() -> list:
    """Every source the port compiles at first use, and every file they
    ``#include "..."``."""
    srcs = sorted((PORT / "csrc").glob("*.cu")) + [PORT / "native" / "fse_native.cpp"]
    out = set(srcs)
    for src in srcs:
        for name in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M):
            out.add((src.parent / name).resolve())
    return sorted(out)


@pytest.mark.parametrize("path", _built_sources(),
                         ids=lambda p: p.relative_to(PORT).as_posix())
def test_built_source_is_package_data(path):
    assert path.exists(), path
    assert _shipped(path), f"{path} is not package data in pyproject.toml"


def test_package_data_check_sees_a_missing_glob():
    assert not _shipped(PORT / "csrc" / "missing.hpp")

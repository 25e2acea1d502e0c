"""The port's multi-process frame pipeline
(entropy_coders_tpu_torch.parallel.multihost) with REAL processes: two and
four torch processes on the CPU (``device="cpu"``), joined by a gloo process
group, compress and decompress through owned blocks, the two-round byte
gather and the ordered merge. Every process's frame must equal, byte for
byte, the single-process port frame (checked in the workers) and the JAX
package's frame (computed here, compared by sha256).

This file is also the worker: ``python tests/test_torch_multihost.py <port>
<num_processes> <process_id> <n_blocks> <leg>...`` prints ``OK`` and a JSON
object of each leg's frame sha256. The worker imports no jax.

Tolerance: exact."""

import hashlib
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

torch = pytest.importorskip("torch")

from entropy_coders_tpu_torch import frame as F  # noqa: E402
from entropy_coders_tpu_torch.parallel import multihost as MH  # noqa: E402
from tests.data.generate_golden import gen_sequence  # noqa: E402

BS = 4096
KW = dict(block_size=BS, k=128, lanes=True, checksum=True)
LEGS = {"global": {},
        "shared": dict(shared_table=True),
        "shared_packed": dict(shared_table=True, bit_pack=True),
        "auto": dict(table_log="auto")}
QUICK = ("global", "shared_packed")


def make_data(n_blocks: int) -> np.ndarray:
    """The JAX multi-host test's input: n_blocks - 1 full blocks and a
    321-byte tail (tests/multihost_worker.py)."""
    return gen_sequence(0.2, (n_blocks - 1) * BS + 321, 0xF5E)


def worker(port: int, num: int, pid: int, n_blocks: int, legs) -> None:
    # the JAX test worker's call (tests/multihost_worker.py)
    MH.init_distributed(f"127.0.0.1:{port}", num_processes=num,
                        process_id=pid, cpu_collectives="gloo")
    data = make_data(n_blocks)
    lo, hi = MH.owned_blocks(n_blocks)
    digests = {}
    for leg in legs:
        kw = {**KW, **LEGS[leg]}
        frame = MH.compress(data, device="cpu", **kw)
        if frame != F.compress(data, device="cpu", **kw):
            raise SystemExit(f"{leg}: multihost frame != single-process frame")
        if MH.decompress(frame, device="cpu") != data.tobytes():
            raise SystemExit(f"{leg}: assembled decompress differs")
        # exactly the owned byte range (b"" for a process owning no block)
        start, local = MH.decompress(frame, assemble=False, device="cpu")
        want = data.tobytes()[lo * BS: min(hi * BS, len(data))]
        if start != lo * BS or local != want:
            raise SystemExit(f"{leg}: owned range differs")
        digests[leg] = hashlib.sha256(frame).hexdigest()
    print("OK", json.dumps({"rank": pid, "owned": [lo, hi],
                            "sha256": digests}), flush=True)
    torch.distributed.destroy_process_group()


# --- the parent -----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_digests():
    """(n_blocks, leg) -> sha256 of the JAX package's frame (Pallas
    kernels in interpret mode), for every leg the workers run."""
    from entropy_coders_tpu import frame as JF

    out = {}
    for n_blocks, legs in ((6, tuple(LEGS)), (3, QUICK)):
        data = make_data(n_blocks)
        for leg in legs:
            frame = JF.compress(data, interpret=True, **KW, **LEGS[leg])
            out[n_blocks, leg] = hashlib.sha256(frame).hexdigest()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(num: int, n_blocks: int, legs) -> list[dict]:
    last = None
    for _ in range(3):  # _free_port is racy (another process may take it)
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(port), str(num), str(i),
             str(n_blocks), *legs], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for i in range(num)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 for p in procs):
            return [json.loads(line[3:]) for out, _ in outs
                    for line in out.splitlines() if line.startswith("OK ")]
        last = outs
    raise AssertionError(f"workers failed 3 attempts:\n{last}")


def test_two_processes_match_jax(jax_digests):
    results = run_workers(2, 6, tuple(LEGS))
    assert [r["owned"] for r in results] == [[0, 3], [3, 6]]
    for r in results:
        for leg in LEGS:
            assert r["sha256"][leg] == jax_digests[6, leg], (r["rank"], leg)


def test_four_processes_uneven_ownership(jax_digests):
    """4 processes over 3 blocks: process 0 owns no block, the others one
    each; the merge skips the empty sub-frame."""
    results = run_workers(4, 3, QUICK)
    assert [r["owned"] for r in results] == [[0, 0], [0, 1], [1, 2], [2, 3]]
    for r in results:
        for leg in QUICK:
            assert r["sha256"][leg] == jax_digests[3, leg], (r["rank"], leg)


def test_single_process_without_group():
    """Outside a process group the pipeline is one process owning every
    block: the single-process frame, and assemble=False returns it all."""
    data = make_data(4)
    for leg in ("global", "shared_packed"):
        kw = {**KW, **LEGS[leg]}
        frame = MH.compress(data, device="cpu", **kw)
        assert frame == F.compress(data, device="cpu", **kw)
        assert MH.decompress(frame, assemble=False, device="cpu") == (
            0, data.tobytes())


def test_single_process_shared_table_resolves_lanes_as_compress_does():
    """With ``lanes`` left to resolve, the shared table's policy is the
    one ``frame.compress`` picks for the same device: the frames agree."""
    data = make_data(4)
    kw = dict(block_size=BS, k=128, checksum=True, shared_table=True)
    frame = MH.compress(data, device="cpu", **kw)
    assert frame == F.compress(data, device="cpu", **kw)


@pytest.mark.parametrize("n,p", [(6, 2), (3, 4), (7, 3), (0, 2)])
def test_owned_blocks_partition(n, p):
    ranges = [MH.owned_blocks(n, p, i) for i in range(p)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_merge_frames_mismatches_raise():
    data = make_data(3)
    total = len(data)

    def sub(lo, hi, **kw):
        return F.compress(data[lo * BS: min(hi * BS, total)], device="cpu",
                          **{**KW, **kw})

    good = [sub(0, 1), sub(1, 3)]
    assert MH._merge_frames(good, total, BS, 128, True) == F.compress(
        data, device="cpu", **KW)
    with pytest.raises(ValueError, match="layout mismatch"):
        MH._merge_frames([sub(0, 1), sub(1, 3, k=256)], total, BS, 128, True)
    with pytest.raises(ValueError, match="layout mismatch"):
        MH._merge_frames(good, total, BS, 128, True, packed=True)
    with pytest.raises(ValueError, match="missing crc table"):
        MH._merge_frames([sub(0, 1, checksum=False), sub(1, 3)], total, BS,
                         128, True)
    with pytest.raises(ValueError, match="block count mismatch"):
        MH._merge_frames(good[:1], total, BS, 128, True)
    shared = [sub(0, 1, shared_table=True), sub(1, 3, shared_table=True)]
    with pytest.raises(ValueError, match="shared table mismatch"):
        MH._merge_frames(shared, total, BS, 128, True,
                         shared_hdr=F._parse_frame(shared[1]).shared_hdr)


def test_init_distributed_needs_every_argument():
    with pytest.raises(ValueError, match="together"):
        MH.init_distributed("127.0.0.1:1", num_processes=2)
    MH.init_distributed()  # a single process: nothing to join
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    port, num, pid, n_blocks = map(int, sys.argv[1:5])
    worker(port, num, pid, n_blocks, sys.argv[5:])

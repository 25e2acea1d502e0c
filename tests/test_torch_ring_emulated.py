"""The CUDA source of B3 (entropy_coders_tpu_torch/csrc/ring.cu), run on the
CPU: its kernel, cut from the file at the host launchers, compiles with g++
against ``tests/cuda_emu/`` (one std::thread per CUDA thread, every CTA of
every rank at once, ``cuda::atomic_ref`` as ``std::atomic_ref``) with its
timer read from a steady clock and 8 threads a CTA. The launch plan
is the wrapper's own (``rdma._stripes``, ``rdma._push_order``).

Each rank's stream waits a while of its own before it fills its output with
0xA5 bytes (the memory's earlier user) and starts its CTAs, and copies the
output out as soon as its CTAs end (the next user): on peer ranks a store
that lands before the peer's kernel started, or a kernel that ends before
its output is whole, shows in the copies. Three calls run on one set of
flags, with epochs 1, 2, 3 and three chunk sizes: 16-byte vectors, 4-byte
words, vectors of another size; every stripe split ends on a short
stripe.

Every rank's output and accumulator are held against ``_ring_call_ref``.
What the emulation cannot show: timing, NVLink, the memory model's
scopes and anything the card's compiler refuses; chip_smoke.py holds the
built kernel against the same version on the card.

Tolerance: exact."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu_torch.parallel import rdma as R  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "entropy_coders_tpu_torch" / "csrc" / "ring.cu"
EMU = Path(__file__).resolve().parent / "cuda_emu"
THREADS = 8      # threads a CTA in the emulation
STRIDE = 4       # flag words a (kind, source rank) row: more than any m here
CPU = torch.device("cpu")


def _c_body(src: str, name: str, body: str) -> str:
    """``src`` with the body of the helper ``name`` replaced by ``body``."""
    out, k = re.subn(r"(\b" + name + r"\([^)]*\)\s*\{).*?\n\}",
                     lambda m: m.group(1) + "\n" + body + "\n}", src,
                     count=1, flags=re.S)
    if k != 1:
        raise AssertionError(f"{name} not found in ring.cu")
    return out


def emulated_source(src: str) -> str:
    """ring.cu's device code with its PTX in C (the timer from a steady
    clock) and a 3 s timeout."""
    src = src[: src.index("// --- host launchers ---")] + "}  // namespace\n"
    src = _c_body(src, "now_ns", "  return (u64)std::chrono::duration_cast<"
                  "std::chrono::nanoseconds>(std::chrono::steady_clock::now()"
                  ".time_since_epoch()).count();")
    src = re.sub(r"kTimeoutNs = [^;]+;", "kTimeoutNs = 3000000000ull;", src)
    if "asm" in src:
        raise AssertionError("PTX left in the emulated source")
    return "#include <chrono>\n" + src


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulation")
    out = tmp_path_factory.mktemp("ring_emu")
    (out / "ring_kernels.cu").write_text(emulated_source(SRC.read_text()))
    lib = out / "libring_emu.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         f"-DRING_THREADS={THREADS}", f"-I{EMU}", f"-I{out}", "-o", str(lib),
         str(EMU / "ring_main.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.emu_ring.argtypes = [P, P, P, P, P, P, P, I, LL, LL, I, I,
                             ctypes.c_ulonglong, I, I, P]
    dll.emu_ring.restype = I
    return dll


def ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(
        *[None if a is None else a.ctypes.data for a in arrays])


def emulated_call(emu, shards, flags, epoch, variant, ctas, peer, acc,
                  delays):
    """One B3 call in the emulation, planned as ``_MeshState.launch`` plans
    it (with ``ctas`` CTAs a rank at most); returns what each rank's stream
    copied out: (outs (n, chunk words), accs or None)."""
    n = len(shards)
    words = shards[0].size
    vecs = words if variant == R.WORDS else words // 4
    m, per = R._stripes(vecs, ctas)
    assert m <= STRIDE
    order = np.array(R._push_order(n), np.int8)
    outs = [np.empty((n, words), np.uint32) for _ in range(n)]
    snaps = [np.empty((n, words), np.uint32) for _ in range(n)]
    accs = [np.empty(words, np.uint32) if acc else None for _ in range(n)]
    acc_snaps = [np.empty(words, np.uint32) if acc else None
                 for _ in range(n)]
    traps = emu.emu_ring(
        ptrs(shards), ptrs(outs), ptrs(accs),
        ptrs(flags if peer else [None] * n), order.ctypes.data, ptrs(snaps),
        ptrs(acc_snaps), n, vecs, per, m, STRIDE, epoch, variant, int(peer),
        np.asarray(delays, np.int32).ctypes.data)
    assert traps == 0, f"{traps} threads trapped (a wait timed out)"
    return snaps, (acc_snaps if acc else None)


@pytest.mark.parametrize("acc", [False, True], ids=["gather", "accumulate"])
@pytest.mark.parametrize("peer", [False, True], ids=["virtual", "peer"])
@pytest.mark.parametrize("ctas", [1, 2, 3])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_emulated_ring_equals_plain(emu, n, ctas, peer, acc):
    """Three calls on one set of flags (epochs 1, 2, 3), each rank's stream
    starting at its own time: 16-byte vectors (a short last stripe), 4-byte
    words, vectors of another size."""
    rng = np.random.default_rng(100 * n + 10 * ctas + 2 * peer + acc)
    flags = [np.zeros(2 * n * STRIDE, np.uint64) for _ in range(n)]
    calls = [(R.VECTORS, 4 * (13 * ctas + 2)), (R.WORDS, 20 * ctas + 3),
             (R.VECTORS, 4 * (9 * ctas + 5))]
    for epoch, (variant, words) in enumerate(calls, start=1):
        assert (variant == R.WORDS) == (words % 4 != 0)
        shards = [rng.integers(0, 1 << 32, words, dtype=np.uint64).astype(
            np.uint32) for _ in range(n)]
        # one rank 3 ms behind the next, in another order each call
        delays = 3000 * rng.permutation(n)
        got, got_acc = emulated_call(emu, shards, flags, epoch, variant, ctas,
                                     peer, acc, delays)
        ref_outs, ref_accs = R._ring_call_ref(
            [torch.from_numpy(s.view(np.int32)) for s in shards], (CPU,) * n,
            accumulate=acc)
        for r in range(n):
            np.testing.assert_array_equal(
                got[r].view(np.int32), ref_outs[r].numpy(),
                err_msg=f"call {epoch}, rank {r} output")
            if acc:
                np.testing.assert_array_equal(
                    got_acc[r].view(np.int32), ref_accs[r].numpy(),
                    err_msg=f"call {epoch}, rank {r} accumulator")
        if peer:  # every word this call used holds its epoch
            m, _ = R._stripes(words // (1 if variant == R.WORDS else 4), ctas)
            for r in range(n):
                f = flags[r].reshape(2, n, STRIDE)
                for q in range(n):
                    if q != r:
                        assert (f[:, q, :m] == epoch).all()

"""The CUDA source of D1/D2 (entropy_coders_tpu_torch/csrc/repack.cu), run
on the CPU: its kernels, cut from the file at the host launchers, compile
with g++ against ``tests/cuda_emu/cuda_runtime.h`` (one std::thread per
CUDA thread, a barrier per warp for the shuffles) with the PTX helpers
replaced by their C meaning (``cp.async``: a copy of ``src_bytes`` and a
zero fill; commit and wait: no-ops, the copy being done at once). A warp
takes one, two or three tiles, so that its double buffer turns over and
some warps start past their group's streams, and the scan's CTAs walk
several blocks each.

The outputs are held against the plain PyTorch versions
(``lane_merge_ref``, ``lane_split_ref``, ``kernel_offsets_ref``) and the
port's C++ library (``native.lane_merge_batch``/``lane_split_batch``).
What the emulation cannot show: timing, the order of asynchronous copies,
bank conflicts and anything the card's compiler refuses; chip_smoke.py
holds the built kernels against the same versions on the card.

Tolerance: exact."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu_torch import native  # noqa: E402
from entropy_coders_tpu_torch.ops import device_repack as DR  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import to_device, to_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "entropy_coders_tpu_torch" / "csrc" / "repack.cu"
EMU = Path(__file__).resolve().parent / "cuda_emu"


def emulated_source(src: str) -> str:
    """repack.cu's device code with its PTX helpers in C and its dynamic
    shared memory taken from the emulator."""
    src = src[: src.index("// Tiles a warp takes")] + "}  // namespace\n"
    src = re.sub(
        r"(void cp_async16\(void\* smem, const void\* gmem,\s*int src_bytes\) \{).*?\n\}",
        r"\1\n  std::memcpy(smem, gmem, src_bytes);\n"
        r"  std::memset((char*)smem + src_bytes, 0, 16 - src_bytes);\n}",
        src, flags=re.S)
    src = re.sub(r"(void cp_async_commit\(\) \{).*?\n\}", r"\1}", src,
                 flags=re.S)
    src = re.sub(r"(void cp_async_wait1\(\) \{).*?\n\}", r"\1}", src,
                 flags=re.S)
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu_dyn_smem;")
    if "asm" in src:
        raise AssertionError("PTX left in the emulated source")
    return src


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulation")
    out = tmp_path_factory.mktemp("repack_emu")
    (out / "repack_kernels.cu").write_text(emulated_source(SRC.read_text()))
    lib = out / "librepack_emu.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         f"-I{EMU}", f"-I{out}", "-o", str(lib),
         str(EMU / "repack_main.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.emu_lane_merge.argtypes = [P, P, P, LL, P, I, I, I, I, I, I]
    dll.emu_lane_split.argtypes = [P, LL, P, P, P, P, I, I, I, I, I, I]
    return dll


def aligned(n: int, dtype, fill) -> np.ndarray:
    """A 64-byte aligned array of n items set to ``fill``."""
    size = np.dtype(dtype).itemsize
    raw = np.empty(n * size + 64, np.uint8)
    start = (-raw.ctypes.data) % 64
    a = raw[start: start + n * size].view(dtype)
    a[:] = fill
    return a


def lanes(seed, B, W, k, lo, hi, guard):
    """Lane words and sizes: sizes in [lo, hi) and, where they fit, a
    zero-size lane, one-bit and one-byte lanes, lanes ending on a word and
    on a 32-row tile, a lane filling all W rows, a block without payload
    and one half empty. Bits past a size are zero, or with ``guard`` set up
    to the end of the lane's last word."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, (B, k)).astype(np.int32)
    if W >= 2:
        sizes[0, :7] = [0, 1, 8, 32, 64, 32 * (W - 1), 32 * W]
    if W > 33:
        sizes[0, 7:9] = [1024, 1056]
    if B >= 3:
        sizes[1] = 0
        sizes[2, : k // 2] = 0
    words = rng.integers(0, 1 << 32, (B, W, k), dtype=np.uint64).astype(
        np.uint32)
    rem = sizes[:, None, :] - 32 * np.arange(W)[None, :, None]
    if guard:
        words &= np.where(rem > 0, 0xFFFFFFFF, 0).astype(np.uint32)
    else:
        words &= np.where(rem >= 32, 0xFFFFFFFF,
                          (1 << np.clip(rem, 0, 31)) - 1).astype(np.uint32)
    return words, sizes


# (B, W, k, smallest size, largest size + 1): 5-bit lanes (a word spans up
# to seven lanes), one row, 32-row tiles and the rows past them
CASES = [(3, 9, 128, 0, 289), (2, 40, 256, 5, 1281), (1, 33, 1024, 1000, 1057),
         (4, 2, 128, 5, 6), (5, 1, 128, 0, 33), (3, 70, 128, 1000, 2241),
         (6, 5, 128, 30, 35), (2, 64, 128, 2000, 2049)]
# (tiles a repack warp takes, scan CTAs): one tile, a tile in flight while
# one is shifted, three; the scan's CTAs walking several blocks each
GRIDS = [(1, 1), (2, 2), (3, 5)]


@pytest.mark.parametrize("C,scan_grid", GRIDS,
                         ids=[f"C{c}" for c, _ in GRIDS])
@pytest.mark.parametrize("guard", [False, True], ids=["clean", "guard"])
@pytest.mark.parametrize("pack", [False, True], ids=["bytes", "packed"])
@pytest.mark.parametrize("B,W,k,lo,hi", CASES,
                         ids=[f"B{c[0]}W{c[1]}k{c[2]}s{c[3]}-{c[4]}"
                              for c in CASES])
def test_emulated_repack_equals_plain_and_native(emu, B, W, k, lo, hi, pack,
                                                 guard, C, scan_grid):
    words, sizes = lanes(B * W + k + hi, B, W, k, lo, hi, guard)
    w = aligned(words.size, np.uint32, words.ravel())
    n_out = B * W * k
    out = aligned(n_out, np.uint32, 0xDEADBEEF)
    meta = aligned(2 * B + 1 + B * (k // 32), np.int64, -7)
    emu.emu_lane_merge(w.ctypes.data, sizes.ctypes.data, out.ctypes.data,
                       n_out, meta.ctypes.data, B, W, k, int(pack), C,
                       scan_grid)
    st = torch.from_numpy(sizes)
    bit_off, offs, goff, nbytes = DR.kernel_offsets_ref(st, pack)
    assert (meta[: B + 1] == offs.numpy()).all()
    assert (meta[B + 1: 2 * B + 1] == nbytes.numpy()).all()
    assert (meta[2 * B + 1:] == goff.numpy().ravel()).all()
    flat = out.view(np.uint8)
    ref = native.lane_merge_batch(words, sizes, pack)
    assert [flat[offs[b]: offs[b + 1]].tobytes() for b in range(B)] == ref
    end = -(-int(offs[-1]) // 4) * 4  # the payload's words, dead bits zero
    plain = to_numpy(DR.lane_merge_ref(to_device(words, "cpu"), st, bit_off,
                                       n_out, pack_bits=pack)).view(np.uint8)
    assert (flat[:end] == plain[:end]).all()

    # the split, from inside a larger buffer, each block from an odd byte
    buf = b"\xff" * 5 + b"".join(ref) + b"\xff" * 7
    n = -(-len(buf) // 4)
    packed = aligned(n, np.uint32, 0)
    packed.view(np.uint8)[: len(buf)] = np.frombuffer(buf, np.uint8)
    boffs = (5 + np.concatenate([[0], np.cumsum([len(r) for r in ref])[:-1]])
             ).astype(np.int64)
    Wd = W + 3
    got = aligned(B * Wd * k, np.uint32, 0xA5A5A5A5)
    scratch = aligned(B * (k // 32), np.int64, -1)
    emu.emu_lane_split(packed.ctypes.data, n, sizes.ctypes.data,
                       boffs.ctypes.data, scratch.ctypes.data, got.ctypes.data,
                       B, Wd, k, int(pack), C, scan_grid)
    got = got.reshape(B, Wd, k)
    assert (got == native.lane_split_batch(ref, sizes, k, Wd, pack)).all()
    split_off, _ = DR.lane_offsets(st, pack, torch.from_numpy(boffs))
    want = DR.lane_split_ref(torch.from_numpy(packed.view(np.int32)).view(
        torch.uint32), st, split_off, W=Wd, pack_bits=pack)
    assert (got == to_numpy(want)).all()


def test_emulated_source_has_no_atomics():
    """Every wire word has one owner: the kernels hold no atomic."""
    assert "atomic" not in SRC.read_text().split("#include <cuda_runtime.h>")[1]

"""The CUDA source of D6 (entropy_coders_tpu_torch/csrc/histogram.cu), run
on the CPU: its kernel, cut from the file at the host launchers, compiles
with g++ against ``tests/cuda_emu/`` and ``tests/cuda_emu/histogram_main.cpp``:
a cooperative launch, every CTA of the grid at once (a std::thread per CUDA
thread), each with its own shared memory filled with garbage, the grid's
barrier over all of them, the later CTAs started first.

The kernel is held against the plain PyTorch version
(``histogram_blocks_ref``) and ``np.bincount``, exactly: blocks cut into
several slices, more units than CTAs, rows shorter than 16 bytes and with
n % 16 != 0 (unaligned row starts), every storage offset 0..15 of the
first row, constant, uniform, geometric and bf16 rows, 32 and 64 threads a
CTA (two warps' sub-histograms), and the output first filled with garbage.
Three broken copies must fail: one without the sum of a block's slices
(each slice stores its counts), one that skips the tail bytes, one without
the grid's barrier between the zeroing of the output and the counts. The
launchers' ctypes signatures are checked against the source.
What the emulation cannot show: timing, and anything the card's compiler
refuses; chip_smoke.py holds the built kernel against the same version on
the card.

Tolerance: exact."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu_torch.kernels import build as KB  # noqa: E402
from entropy_coders_tpu_torch.ops import histogram as H  # noqa: E402
from tests.histogram_rows import KINDS, rows  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "entropy_coders_tpu_torch" / "csrc" / "histogram.cu"
EMU = Path(__file__).resolve().parent / "cuda_emu"
GARBAGE = 0x5A5A5A5A5A5A5A5A
STAGGER_US = 200


def emulated_source(src: str) -> str:
    """histogram.cu's device code with its dynamic shared memory taken
    from the emulator."""
    src = src[: src.index("// --- host launchers ---")]
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_cta_smem;")
    if "asm" in src or "__shared__" in src:
        raise AssertionError("PTX or static shared memory in the source")
    return src


def no_slice_sum(src: str) -> str:
    old = "atomicAdd(out + b * kBins + bin, (unsigned long long)total);"
    assert old in src
    return src.replace(old, "out[b * kBins + bin] = total;")


def no_tail(src: str) -> str:
    old = "if (tid < len - tail_at) atomicAdd(&h[p[tail_at + tid]], 1u);"
    assert old in src
    return src.replace(old, "")


def no_grid_sync(src: str) -> str:
    old = "cg::this_grid().sync();"
    assert src.count(old) == 1
    return src.replace(old, "__syncthreads();")


def _build(out: Path, src: str) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulation")
    out.mkdir(parents=True, exist_ok=True)
    (out / "histogram_kernels.cu").write_text(src)
    lib = out / "libhistogram_emu.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         f"-I{EMU}", f"-I{out}", "-o", str(lib),
         str(EMU / "histogram_main.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.emu_histogram.argtypes = [P, LL, I, I, I, I, I, P, I]
    return dll


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("histogram_emu"),
                  emulated_source(SRC.read_text()))


def run(lib, blocks: np.ndarray, slice_: int, grid: int, T: int,
        offset: int = 0, stagger_us: int = STAGGER_US) -> np.ndarray:
    """The kernel on ``blocks`` (B, n), its first row ``offset`` bytes past
    a 16-byte boundary; the (B, 256) int64 counts."""
    B, n = blocks.shape
    buf = np.zeros(B * n + 32, np.uint8)
    at = (-buf.ctypes.data) % 16 + offset
    buf[at: at + B * n] = blocks.reshape(-1)
    S = -(-n // slice_)
    out = np.full((B, 256), GARBAGE, np.uint64).view(np.int64)
    rc = lib.emu_histogram(buf.ctypes.data + at, n, B, slice_, S, grid, T,
                           out.ctypes.data, stagger_us)
    assert rc == 0
    return out


def expected(blocks: np.ndarray) -> np.ndarray:
    ref = H.histogram_blocks_ref(torch.from_numpy(blocks)).numpy()
    want = np.stack([np.bincount(r, minlength=256) for r in blocks]) \
        if blocks.shape[1] else np.zeros((blocks.shape[0], 256), np.int64)
    assert (ref == want).all()
    return ref


# (B, n, slice, grid, T): one unit; slices over fewer CTAs; a ragged last
# slice at n % 16 == 1; one byte in a row's second slice; rows of fewer than
# 16 bytes (head and tail only); 128 KiB rows in 8 slices
CASES = [(1, 4096, 4096, 1, 64), (1, 4096, 512, 3, 64),
         (3, 4097, 1024, 4, 64), (9, 17, 16, 5, 32), (2, 15, 16, 2, 32),
         (4, 1, 16, 3, 32), (3, 1000, 48, 8, 32), (2, 131072, 16384, 6, 64)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,n,slice_,grid,T", CASES,
                         ids=[f"B{c[0]}-n{c[1]}-s{c[2]}-g{c[3]}-T{c[4]}"
                              for c in CASES])
def test_emulated_histogram_equals_plain(emu, B, n, slice_, grid, T, kind):
    blocks = rows(kind, B, n, seed=B * 7919 + n)
    offset = (B * 5 + n) % 16
    assert (run(emu, blocks, slice_, grid, T, offset) == expected(blocks)).all()


@pytest.mark.parametrize("offset", range(16))
def test_emulated_storage_offsets(emu, offset):
    """The first row at every offset from a 16-byte boundary, rows of 4,099
    bytes (each row's start moves by 3 more): head, body and tail split
    differently in every row."""
    blocks = rows("uniform", 3, 4099, seed=offset)
    assert (run(emu, blocks, 1024, 3, 64, offset) == expected(blocks)).all()


def test_emulated_wrapper_pick(emu):
    """The slices and grid the wrapper picks (``launch_config``), on a
    small grid: every unit counted once."""
    blocks = rows("geometric", 5, 100_000, seed=9)
    S, slice_, grid = H.launch_config(5, 100_000, 8)
    assert S > 1 and grid == 8
    assert (run(emu, blocks, slice_, grid, 64, 3) == expected(blocks)).all()


@pytest.mark.parametrize("mutant,kind,case", [
    (no_slice_sum, "uniform", (2, 4096, 512, 4, 64)),
    (no_tail, "geometric", (3, 4097, 1024, 4, 64)),
    (no_grid_sync, "uniform", (1, 8192, 1024, 4, 64))],
    ids=["no_slice_sum", "no_tail", "no_grid_sync"])
def test_broken_copies_fail(tmp_path, mutant, kind, case):
    B, n, slice_, grid, T = case
    lib = _build(tmp_path, mutant(emulated_source(SRC.read_text())))
    blocks = rows(kind, B, n, seed=17)
    got = run(lib, blocks, slice_, grid, T, stagger_us=50000)
    assert not (got == expected(blocks)).all()


def test_shared_memory_is_dynamic():
    """The kernel's shared memory is one dynamic buffer sized from the
    launch (a sub-histogram a warp), nothing static."""
    body = SRC.read_text().split("// --- host launchers ---")[0]
    assert body.count("__shared__") == 1
    assert "extern __shared__" in body


def c_params(src: str, fn: str) -> list:
    """The parameter types of ``extern "C" int fn(...)`` in ``src``, as
    ctypes would take them."""
    head = src[src.index(f'extern "C" int {fn}('):]
    params = head[head.index("(") + 1: head.index(")")].split(",")
    return [ctypes.c_void_p if "*" in p
            else ctypes.c_longlong if "long long" in p else ctypes.c_int
            for p in (" ".join(q.split()) for q in params)]


@pytest.mark.parametrize("fn", ["ect_histogram", "ect_histogram_max_ctas"])
def test_launcher_signatures_match_the_source(fn):
    assert KB._SIGNATURES[fn] == c_params(SRC.read_text(), fn)

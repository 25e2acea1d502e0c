"""The CUDA source of the crc kernel (entropy_coders_tpu_torch/csrc/crc32.cu),
run on the CPU: its two kernels, cut from the file at the host launchers,
compile with g++ against ``tests/cuda_emu/`` and
``tests/cuda_emu/crc_main.cpp``: the chunk kernel's CTAs all at once (a
std::thread per CUDA thread), each with its own shared memory filled with
garbage, the later CTAs started first; then the join, a warp a row.

The kernels are held against ``zlib.crc32`` and the plain PyTorch version
(``crc32_blocks_ref``), exactly: row lengths 0, 1, 15, 16, 17, 4,095-4,097
and rows many chunks long; the first row at every offset 0..15 from a
16-byte boundary; more chunks than CTAs; two-piece rows (a decoded block's
symbols, then its finals, from two places); 32 and 64 threads a CTA, and
``partial`` and the output first filled with garbage. Three broken copies
must fail: one that joins no chunks (a row takes its first chunk's crc),
one that shifts each segment by one segment too many, and one that skips
zlib's register set and final inversion. The launchers' ctypes signatures
are checked against the source, and the wrapper's routing on the CPU.
What the emulation cannot show: timing, and anything the card's compiler
refuses; chip_smoke.py holds the built kernel against the same version and
``zlib.crc32`` on the card.

Tolerance: exact."""

import ctypes
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu_torch.kernels import build as KB  # noqa: E402
from entropy_coders_tpu_torch.ops import crc as K  # noqa: E402
from tests.test_torch_histogram_emulated import c_params  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "entropy_coders_tpu_torch" / "csrc" / "crc32.cu"
EMU = Path(__file__).resolve().parent / "cuda_emu"
GARBAGE = 0x5A5A5A5A
STAGGER_US = 200


def emulated_source(src: str) -> str:
    """crc32.cu's device code with its dynamic shared memory taken from
    the emulator."""
    src = src[: src.index("// --- host launchers ---")]
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_cta_smem;")
    if "asm" in src or "__shared__" in src:
        raise AssertionError("PTX or static shared memory in the source")
    return src


def no_chunk_join(src: str) -> str:
    old = "for (int c = lane; c < U; c += 32) x ^= partial[row * U + c];"
    assert old in src
    return src.replace(old, "if (lane == 0 && U) x = partial[row * U];")


def wrong_shift(src: str) -> str:
    old = "xpow8((unsigned long long)(T - 1 - tid) * seg)"
    assert src.count(old) == 1
    return src.replace(old, "xpow8((unsigned long long)(T - tid) * seg)")


def no_init_xor(src: str) -> str:
    old = "out[row] = x ^ ~mulmod(0xFFFFFFFFu, f);"
    assert old in src
    return src.replace(old, "out[row] = x;")


def _build(out: Path, src: str) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulation")
    out.mkdir(parents=True, exist_ok=True)
    (out / "crc32_kernels.cu").write_text(src)
    lib = out / "libcrc_emu.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         f"-I{EMU}", f"-I{out}", "-o", str(lib), str(EMU / "crc_main.cpp")],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.emu_crc32.argtypes = [P, LL, LL, P, LL, LL, I, I, I, I, I, P, P, I]
    return dll


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("crc_emu"),
                  emulated_source(SRC.read_text()))


def _at(arr: np.ndarray, offset: int):
    """A copy of ``arr`` whose first byte lies ``offset`` bytes past a
    16-byte boundary: (the buffer that holds it, its address)."""
    buf = np.zeros(arr.size + 32, np.uint8)
    at = (-buf.ctypes.data) % 16 + offset
    buf[at: at + arr.size] = arr.reshape(-1)
    return buf, buf.ctypes.data + at


def run(lib, rows: np.ndarray, tail: np.ndarray | None = None, *,
        seg: int = 16, grid: int = 4, T: int = 32, offset: int = 0,
        stagger_us: int = STAGGER_US) -> np.ndarray:
    """The two kernels on ``rows`` (B, n1), each followed by its row of
    ``tail`` (B, n2), the first row ``offset`` bytes past a 16-byte
    boundary; the (B,) uint32 crcs."""
    B, n1 = rows.shape
    n2 = 0 if tail is None else tail.shape[1]
    buf1, p1 = _at(rows, offset)
    buf2, p2 = _at(tail if n2 else np.zeros(0, np.uint8), (offset + 5) % 16)
    C = T * seg
    U = -(-n1 // C) + -(-n2 // C)
    grid = max(1, min(grid, B * U))
    partial = np.full(max(B * U, 1), GARBAGE, np.uint32)
    out = np.full(B, GARBAGE, np.uint32)
    rc = lib.emu_crc32(p1, n1, n1, p2, n2, n2, B, seg, U, grid, T,
                       partial.ctypes.data, out.ctypes.data, stagger_us)
    del buf1, buf2  # held until the call has read them
    assert rc == 0
    return out


def expected(rows: np.ndarray, tail: np.ndarray | None = None) -> np.ndarray:
    """zlib.crc32 of each row (and its tail), held equal to the plain
    version first."""
    want = np.array([zlib.crc32(r.tobytes() + (b"" if tail is None
                                               else tail[i].tobytes()))
                     for i, r in enumerate(rows)], np.uint32)
    ref = K.crc32_blocks_ref(torch.from_numpy(rows), None if tail is None
                             else torch.from_numpy(tail))
    assert (ref.view(torch.int32).numpy().view(np.uint32) == want).all()
    return want


def _rows(B: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (B, n), np.uint8)


# (B, n, seg, grid, T): empty and tiny rows; one chunk; 4,095-4,097 bytes
# in several chunks over fewer CTAs; rows many chunks long at 64 threads
LENGTHS = [(2, 0, 16, 1, 32), (3, 1, 16, 2, 32), (2, 15, 16, 2, 32),
           (2, 16, 16, 2, 32), (2, 17, 16, 2, 32), (2, 4095, 32, 5, 32),
           (1, 4096, 32, 3, 32), (3, 4097, 48, 7, 64),
           (1, 100_003, 64, 6, 64)]


@pytest.mark.parametrize("B,n,seg,grid,T", LENGTHS,
                         ids=[f"B{c[0]}-n{c[1]}-s{c[2]}-g{c[3]}-T{c[4]}"
                              for c in LENGTHS])
def test_emulated_crc_equals_zlib(emu, B, n, seg, grid, T):
    rows = _rows(B, n, seed=B * 7919 + n)
    assert (run(emu, rows, seg=seg, grid=grid, T=T, offset=n % 16)
            == expected(rows)).all()


@pytest.mark.parametrize("offset", range(16))
def test_emulated_storage_offsets(emu, offset):
    """The first row at every offset from a 16-byte boundary, rows of 1,027
    bytes (each row's start moves by 3 more): head, body and tail of every
    segment split differently in every row."""
    rows = _rows(3, 1027, seed=offset)
    assert (run(emu, rows, seg=32, grid=3, offset=offset)
            == expected(rows)).all()


def test_emulated_more_chunks_than_ctas(emu):
    """Rows of 40 chunks each over 3 CTAs: every CTA takes many units."""
    rows = _rows(3, 40 * 32 * 16 - 5, seed=3)
    assert (run(emu, rows, seg=16, grid=3) == expected(rows)).all()


# (B, n1, n2, seg, T): a decoded block's shape (R * k symbols, k finals);
# symbols of several chunks and finals of one; either piece empty; finals
# longer than a chunk
PIECES = [(3, 7 * 128, 128, 16, 32), (2, 5000, 128, 32, 32),
          (2, 0, 300, 16, 32), (2, 300, 0, 16, 32), (1, 33, 2049, 16, 64)]


@pytest.mark.parametrize("B,n1,n2,seg,T", PIECES,
                         ids=[f"B{c[0]}-{c[1]}+{c[2]}-s{c[3]}-T{c[4]}"
                              for c in PIECES])
def test_emulated_two_pieces(emu, B, n1, n2, seg, T):
    rows, tail = _rows(B, n1, seed=n1), _rows(B, n2, seed=n2 + 1)
    assert (run(emu, rows, tail, seg=seg, grid=5, T=T, offset=n1 % 16)
            == expected(rows, tail)).all()


@pytest.mark.parametrize("mutant", [no_chunk_join, wrong_shift, no_init_xor],
                         ids=["no_chunk_join", "wrong_shift", "no_init_xor"])
def test_broken_copies_fail(tmp_path, mutant):
    lib = _build(tmp_path, mutant(emulated_source(SRC.read_text())))
    rows = _rows(2, 4097, seed=17)
    assert not (run(lib, rows, seg=16, grid=4) == expected(rows)).all()


def test_shared_memory_is_dynamic():
    """The kernel's shared memory is one dynamic buffer sized from the
    launch (the tables and a word a warp), nothing static."""
    body = SRC.read_text().split("// --- host launchers ---")[0]
    assert body.count("__shared__") == 1
    assert "extern __shared__" in body


def test_shift_powers_match_the_source():
    """The kernel's ``kX8`` table is the plain version's ``X8``."""
    body = SRC.read_text()
    table = body[body.index("kX8[32] = {") + 11: body.index("};")]
    assert [int(w.strip().rstrip("u"), 16) for w in table.split(",")] == K.X8


@pytest.mark.parametrize("fn", ["ect_crc32", "ect_crc32_max_ctas"])
def test_launcher_signatures_match_the_source(fn):
    assert KB._SIGNATURES[fn] == c_params(SRC.read_text(), fn)


@pytest.mark.parametrize("B,n1,n2", [(0, 16, 0), (3, 0, 0), (2, 0, 5),
                                     (4, 4097, 0), (2, 70_000, 129)])
def test_wrapper_runs_the_plain_version_on_the_cpu(B, n1, n2):
    """A CPU tensor takes ``crc32_blocks_ref`` and launches nothing; a
    strided view of rows (rows apart by more than their length) too."""
    wide = _rows(max(B, 1), n1 + 9, seed=n1)[:B]
    rows = torch.from_numpy(wide)[:, 3: 3 + n1]
    tail = torch.from_numpy(_rows(B, n2, seed=5)) if n2 else None
    before = K.CRC_LAUNCHES
    got = K.crc32_blocks(rows, tail)
    assert K.CRC_LAUNCHES == before
    assert got.dtype == torch.uint32 and got.shape == (B,)
    want = expected(np.ascontiguousarray(rows.numpy()),
                    None if tail is None else tail.numpy())
    assert (got.view(torch.int32).numpy().view(np.uint32) == want).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rows = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        K.crc32_blocks(rows.to(torch.int16))
    with pytest.raises(ValueError):
        K.crc32_blocks(rows.t())  # a row's bytes apart
    with pytest.raises(ValueError):
        K.crc32_blocks(rows, torch.zeros((3, 4), dtype=torch.uint8))
    with pytest.raises(TypeError):
        K.crc32_blocks(np.zeros((2, 8), np.uint8))

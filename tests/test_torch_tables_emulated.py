"""The CUDA source of D3 (entropy_coders_tpu_torch/csrc/tables.cu), run on
the CPU: its kernel, cut from the file at the host launchers, compiles with
g++ against ``tests/cuda_emu/`` (one std::thread per CUDA thread, a barrier
per warp for the shuffles and ``__match_any_sync``) and
``tests/cuda_emu/tables_main.cpp``: the blocks of a table's thread-block
cluster run at once, each with its own shared memory, and read each
other's through ``cooperative_groups``' ``map_shared_rank`` after the
cluster's barrier. The later blocks of a cluster start first, so a read
before the barrier sees another block's shared memory unwritten.

Both halves of the tables are held against the plain PyTorch version
(``build_tables_ref``) and the port's C++ library
(``native.build_encode_tables``/``build_decode_tables``) at L = 5..15,
B in {1, 4, 9} and clusters of 1, 2 and 8 blocks (the threads a block the
wrapper picks for that cluster, ``launch_config``), on counts with -1
(low-probability) symbols and an alphabet that ends below 255; a launch of
one half leaves the other half's arrays as they were. Two broken copies of
the source, one without the cluster's barrier and one without the sort of
the skipped visits, must fail.
What the emulation cannot show: timing, the card's scheduling of a
cluster, and anything the card's compiler refuses; chip_smoke.py holds
the built kernel against the same versions on the card.

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
from entropy_coders_tpu_torch.ops import tables as TB  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import to_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "entropy_coders_tpu_torch" / "csrc" / "tables.cu"
EMU = Path(__file__).resolve().parent / "cuda_emu"
H100_SMS = 132
STAGGER_US = 300  # a later block of a cluster starts this much earlier
POISON = 0xA5


def emulated_source(src: str) -> str:
    """tables.cu's device code with its dynamic shared memory taken from
    the emulator."""
    src = src[: src.index("// --- host launchers ---")] + "}  // namespace\n"
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem[];",
        "unsigned char* smem = emu_cta_smem;")
    if "asm" in src or "__shared__" in src:
        raise AssertionError("PTX or static shared memory in the source")
    return src


def no_cluster_barrier(src: str) -> str:
    out, n = re.subn(r"(cluster|cg::this_cluster\(\))\.sync\(\);", ";", src)
    assert n == 2, n
    return out


def unsorted_skips(src: str) -> str:
    old = "skipped[rank] = v;"
    assert old in src
    return src.replace(old, "skipped[i] = v;")


def _build(out: Path, src: str) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulation")
    out.mkdir(parents=True, exist_ok=True)
    (out / "tables_kernels.cu").write_text(src)
    lib = out / "libtables_emu.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         f"-I{EMU}", f"-I{out}", "-o", str(lib),
         str(EMU / "tables_main.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.emu_build_tables.argtypes = [P, P, P, P, P, I, I, I, I, I, I]
    return dll


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("tables_emu"),
                  emulated_source(SRC.read_text()))


def norm_rows(seed: int, B: int, L: int, min_sym: int = 2) -> np.ndarray:
    """(B, 256) int32 normalized counts at table log L: a random set of
    symbols below min(250, 2^(L-1) - 2) (so table_len < 256, with zero
    counts between; a larger symbol would raise the table log), a quarter
    of them seen once in 2^24 bytes, so that they normalize to -1 at every
    L, the rest with geometric weights."""
    rng = np.random.default_rng(seed)
    top = min(250, (1 << (L - 1)) - 2)
    rows = []
    for _ in range(B):
        n_sym = int(rng.integers(min_sym, min(200, top, 1 << (L - 2)) + 1))
        syms = np.sort(rng.choice(top, n_sym, replace=False))
        n_rare = max(1, n_sym // 4) if n_sym > 2 else 0
        hist = np.zeros(256, np.int64)
        weights = rng.geometric(0.1, n_sym - n_rare).astype(np.float64)
        hist[syms[n_rare:]] = np.maximum(1, weights / weights.sum()
                                         * (1 << 24)).astype(np.int64)
        hist[syms[:n_rare]] = 1
        nt, l2 = native.normalize(hist, int(hist.sum()), L)
        assert l2 == L
        rows.append(nt)
    nt = np.stack(rows).astype(np.int32)
    assert (nt == -1).any() or B == 1
    return nt


def run(lib, nt: np.ndarray, L: int, half: str, C: int, T: int | None = None,
        stagger_us: int = STAGGER_US):
    """The kernel on ``nt``: (dec, tt_bits, tt_fs, next_state) as numpy,
    every array first filled with POISON bytes."""
    B = nt.shape[0]
    if T is None:
        T = TB.launch_config(B, L, H100_SMS, C)[1]
    size = 1 << L
    out = [np.full(B * size * 4, POISON, np.uint8).view(np.uint32).reshape(
               B, size),
           np.full(B * 1024, POISON, np.uint8).view(np.uint32).reshape(B, 256),
           np.full(B * 1024, POISON, np.uint8).view(np.int32).reshape(B, 256),
           np.full(B * size * 2, POISON, np.uint8).view(np.uint16).reshape(
               B, size)]
    nt = np.ascontiguousarray(nt, np.int32)
    rc = lib.emu_build_tables(nt.ctypes.data, out[0].ctypes.data,
                              out[3].ctypes.data, out[1].ctypes.data,
                              out[2].ctypes.data, B, L, TB.HALVES[half], C, T,
                              stagger_us)
    assert rc == 0
    return out


def expected(nt: np.ndarray, L: int):
    """(plain version's arrays as numpy, the C++ library's), LaneTables
    order."""
    ref = [to_numpy(t) for t in TB.build_tables_ref(torch.from_numpy(nt), L)]
    table, tt_bits, tt_fs = native.build_encode_tables(nt, L)
    return ref, [native.build_decode_tables(nt, L), tt_bits, tt_fs, table]


NAMES = ("dec", "tt_bits", "tt_fs", "next_state")
CASES = [(L, B, C) for L in range(5, 16) for B in (1, 4, 9) for C in (1, 2, 8)
         if (1 << L) // C >= 32]


@pytest.mark.parametrize("L,B,C", CASES,
                         ids=[f"L{L}-B{B}-C{C}" for L, B, C in CASES])
def test_emulated_tables_equal_plain_and_native(emu, L, B, C):
    nt = norm_rows(1000 * L + 10 * B + C, B, L)
    got = run(emu, nt, L, "both", C)
    ref, cpp = expected(nt, L)
    for name, g, r, c in zip(NAMES, got, ref, cpp):
        assert (g == r).all(), f"{name} != plain version"
        assert (g == c).all(), f"{name} != C++"


HALF_CASES = [(half, L, C) for half in ("decode", "encode")
              for L, C in ((6, 2), (10, 1), (12, 8), (15, 8))]


@pytest.mark.parametrize("half,L,C", HALF_CASES,
                         ids=[f"{h}-L{L}-C{C}" for h, L, C in HALF_CASES])
def test_emulated_half_writes_only_its_arrays(emu, half, L, C):
    """A launch of one half fills its arrays and leaves the other half's
    bytes as they were."""
    nt = norm_rows(77 * L + C, 4, L)
    got = run(emu, nt, L, half, C)
    ref, _ = expected(nt, L)
    built = {"decode": (0,), "encode": (1, 2, 3)}[half]
    for i, (name, g, r) in enumerate(zip(NAMES, got, ref)):
        if i in built:
            assert (g == r).all(), f"{name} != plain version"
        else:
            assert (g.view(np.uint8) == POISON).all(), f"{name} written"


def test_emulated_blocks_of_one_thread_count(emu):
    """The kernel takes its thread count from the launch: 128, 256 and 512
    threads build the same tables at one cluster size."""
    nt = norm_rows(5, 2, 11)
    ref, _ = expected(nt, 11)
    for T in (128, 256, 512):
        got = run(emu, nt, 11, "both", 2, T)
        assert all((g == r).all() for g, r in zip(got, ref)), T


@pytest.mark.parametrize("B,L,C,T", [(4, 15, 8, 512), (1, 15, 8, 512),
                                     (4, 11, 2, 512), (8, 11, 2, 512),
                                     (4, 8, 1, 256), (8, 8, 1, 256),
                                     (512, 10, 1, 256), (1022, 10, 1, 128),
                                     (40, 15, 2, 512), (132, 13, 1, 512),
                                     (66, 13, 2, 512), (4, 5, 1, 128)])
def test_launch_config_picks(B, L, C, T):
    """The cluster sizes the wrapper picks on a 132-SM card: 8 for a few
    tables at L = 15, none for the default point's ~1,022 at L = 10; never
    more CTAs than SMs once clustered, never fewer than 1,024 slots a CTA
    in a cluster; a thread a slot of the CTA, within 128..512, halved
    while the CTAs would take more than half of the card's threads."""
    got_c, got_t = TB.launch_config(B, L, H100_SMS)
    assert (got_c, got_t) == (C, T)
    assert got_t == TB.launch_config(B, L, H100_SMS, C)[1]
    assert 128 <= got_t <= min(512, max(128, (1 << L) // C))
    assert got_t == min(512, max(128, (1 << L) // C)) or \
        B * C * got_t * 2 > H100_SMS * 1024
    if C > 1:
        assert B * C <= H100_SMS and (1 << L) // C >= 1024


def test_broken_cluster_barrier_fails(tmp_path):
    """Without the cluster's barrier a block reads the counts of the blocks
    before it before they are written: the tables differ."""
    lib = _build(tmp_path, no_cluster_barrier(
        emulated_source(SRC.read_text())))
    nt = norm_rows(11, 2, 12)
    got = run(lib, nt, 12, "both", 8, stagger_us=30000)
    ref, _ = expected(nt, 12)
    assert not (got[0] == ref[0]).all()


def test_unsorted_skipped_visits_fail(tmp_path):
    """Without the sort of the skipped visits the binary search over them
    miscounts, and the spread puts symbols in the wrong slots."""
    lib = _build(tmp_path, unsorted_skips(emulated_source(SRC.read_text())))
    nt = norm_rows(12, 4, 9, min_sym=40)
    assert ((nt == -1).sum(1) >= 10).all()
    got = run(lib, nt, 9, "both", 1)
    ref, _ = expected(nt, 9)
    assert not (got[0] == ref[0]).all()


def test_shared_memory_is_dynamic():
    """The kernel's shared memory is one dynamic buffer sized from the
    launch (its slots and threads), nothing static."""
    body = SRC.read_text().split("// --- host launchers ---")[0]
    assert body.count("__shared__") == 1
    assert "extern __shared__" in body

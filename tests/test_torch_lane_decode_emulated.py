"""The CUDA source of B1 and of the layout kernel B4/B5
(entropy_coders_tpu_torch/csrc/lane_decode.cuh, one kernel templated on the
table format), run on the CPU: the header, cut at its host launchers,
compiles with g++ against ``tests/cuda_emu/cuda_runtime.h`` (one
std::thread per CUDA thread) and ``tests/cuda_emu/lane_decode_main.cpp``
with its PTX replaced by its C meaning (``bmsk.clamp``: a mask; the
predicated refill: an ``if``) and ``cp.async`` a copy at once, the
strictest order for the lanes' word ring. T = 128 threads a CTA, k = 128
lanes, R <= 64 rounds: one or two output tiles, the second partial.

Each of the five formats (flat, split, upack, fused, nosym) is held against
the layout kernel's plain version (``decode_lanes_layout_ref``), and flat,
B1's own format, against B1's plain version (``PL.decode_lanes_ref``), on
streams the port's encoder wrote at table logs 5..15 (as far as a format
goes), both refill groups, and with one lane's size corrupted past what its
rounds consume (the cursor goes negative; rows outside the words read as
zero). What the emulation cannot show: timing, the order of the
asynchronous copies, and anything the card's compiler refuses;
chip_smoke.py holds the built kernels against the same versions on the
card.

Tolerance: exact."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu_torch.normalize import normalize_batch  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.tools import l10_attack_harness as H  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "entropy_coders_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"
K = 128

# lane_launch.cuh's device helpers in C: a cp.async lands at once
LANE_LAUNCH = """#pragma once
#include <cstdint>
#include <cstring>
namespace ect_lane {
constexpr int kMaxGridY = 65535;
inline void cp_async16(void* smem, const void* gmem) { std::memcpy(smem, gmem, 16); }
inline void cp_async4(void* smem, const void* gmem) { std::memcpy(smem, gmem, 4); }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
}  // namespace ect_lane
"""


def _c_body(src: str, name: str, body: str) -> str:
    """``src`` with the body of the function ``name`` replaced by ``body``."""
    out, n = re.subn(r"(\b" + name + r"\([^)]*\)\s*\{).*?\n\}",
                     lambda m: m.group(1) + "\n" + body + "\n}", src,
                     count=1, flags=re.S)
    if n != 1:
        raise AssertionError(f"{name} not found in lane_decode.cuh")
    return out


def emulated_source(src: str) -> str:
    """lane_decode.cuh's device code, its PTX in C and its dynamic shared
    memory taken from the emulator."""
    src = src[: src.index("// --- host launchers ---")]
    src += "}  // namespace\n}  // namespace ect_lane\n"
    src = _c_body(src, "bits_mask",
                  "  return nb >= 32 ? 0xFFFFFFFFu << SH : ((1u << nb) - 1u) << SH;")
    src = _c_body(src, "refill_if",
                  "  if (cur < TH) { hi = lo; lo = w; cur += 32; rs -= step; }")
    src = src.replace("extern __shared__ __align__(16) uint32_t s_tab[];",
                      "uint32_t* s_tab = (uint32_t*)emu_dyn_smem;")
    if "asm" in src or "__shared__" in src:
        raise AssertionError("PTX or static shared memory left in the source")
    return src


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulation")
    out = tmp_path_factory.mktemp("lane_decode_emu")
    (out / "lane_launch.cuh").write_text(LANE_LAUNCH)
    (out / "lane_decode_kernels.cuh").write_text(
        emulated_source((CSRC / "lane_decode.cuh").read_text()))
    lib = out / "liblane_decode_emu.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         f"-I{out}", f"-I{EMU}", "-o", str(lib),
         str(EMU / "lane_decode_main.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.emu_lane_decode.argtypes = [I, P, P, P, P, P, P, P] + [I] * 6
    return dll


def lane_case(seed: int, L: int, R: int, B: int = 2):
    """(words, sizes, dec, norm tables): B blocks of (R + 1) * 128 bytes of
    fewer than 128 symbols, spread enough that no count passes 256 up to
    L = 13 (so upack applies), encoded by the port at table log L."""
    rng = np.random.default_rng(seed)
    n = (R + 1) * K
    top = min(120, (1 << (L - 1)) - 2)
    geo = (rng.geometric(0.1, (B, n)) - 1).clip(0, top)
    flat = rng.integers(0, top + 1, (B, n))
    blocks = np.where(rng.random((B, n)) < 0.9, flat, geo).astype(np.uint8)
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks])
    nt, l2 = normalize_batch(counts, n, L)
    assert (l2 == L).all()
    words, sizes = PL.encode_lanes_norm(torch.from_numpy(blocks), nt, k=K,
                                        L=L, W=PL.encode_w_bound(R, L))
    dec = PL.tables_from_norm(nt, L, "cpu", half="decode").dec
    return words.contiguous(), sizes, dec, nt


def run(lib, layout, words, sizes, table, L, R, RF):
    B, W, k = words.shape
    syms = np.full((B, R, k), 0x5A, np.uint8)
    finals = np.full((B, k), 0x5A, np.uint8)
    cursors = np.full((B, k), -7, np.int32)
    planes = [np.ascontiguousarray(p.view(torch.uint8).numpy())
              for p in table]
    w = np.ascontiguousarray(words.view(torch.int32).numpy())
    s = np.ascontiguousarray(sizes.numpy())
    rc = lib.emu_lane_decode(
        H.LAYOUTS.index(layout), w.ctypes.data, s.ctypes.data,
        planes[0].ctypes.data, planes[1].ctypes.data if len(planes) > 1 else
        None, syms.ctypes.data, finals.ctypes.data, cursors.ctypes.data, B,
        W, k, L, R, RF)
    assert rc == 0
    return syms, finals, cursors


CASES = [(layout, L, R) for layout in H.LAYOUTS
         for L, R in ((5, 64), (8, 33), (10, 32), (11, 64), (12, 17),
                      (13, 40), (15, 64))
         if L <= H._MAX_L[layout]]


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupt"])
@pytest.mark.parametrize("layout,L,R", CASES,
                         ids=[f"{c[0]}-L{c[1]}-R{c[2]}" for c in CASES])
def test_emulated_layout_equals_plain(emu, layout, L, R, corrupt):
    words, sizes, dec, nt = lane_case(31 * L + R, L, R)
    if not H.layout_applies(layout, nt, L):
        assert layout == "upack" and L == 15  # counts past 256 there
        return
    if corrupt:
        sizes = sizes.clone()
        sizes[0, 3] ^= 0x4000
    table = H.layout_tables(dec, L, layout)
    _, RF = PL.lane_config("decode", K, L)
    got = run(emu, layout, words, sizes, table, L, R, RF)
    want = H.decode_lanes_layout_ref(words, sizes, table, layout=layout, L=L,
                                     R=R)
    for name, g, w in zip(("syms", "finals", "cursors"), got, want):
        assert (g == w.numpy()).all(), name
    assert bool(got[2][0, 3] != 0) == corrupt
    if layout == "flat":  # B1 itself
        ref = PL.decode_lanes_ref(words, sizes, dec, L=L, R=R)
        for name, g, w in zip(("syms", "finals", "cursors"), got, ref):
            assert (g == w.numpy()).all(), f"{name} != B1's plain version"


@pytest.mark.parametrize("RF", [1, 2])
def test_emulated_flat_both_refill_groups(emu, RF):
    """B1's refill group of one round (any L) and of two (L <= 10) decode
    the same streams."""
    words, sizes, dec, _ = lane_case(9, 9, 64)
    got = run(emu, "flat", words, sizes, (dec,), 9, 64, RF)
    ref = PL.decode_lanes_ref(words, sizes, dec, L=9, R=64)
    for g, w in zip(got, ref):
        assert (g == w.numpy()).all()


def test_b1_is_the_flat_instantiation():
    """pl_decode.cu launches the header's kernel in the flat format, and the
    layout kernel launches the same kernel for its five formats: no decode
    body of its own in either file."""
    b1 = (CSRC / "pl_decode.cu").read_text()
    lay = (CSRC / "pl_decode_layout.cu").read_text()
    assert "decode_launch_pick<ect_lane::FlatFormat>" in b1
    for fmt in ("Flat", "Split", "Upack", "Fused", "Nosym"):
        assert f"ECT_LAYOUT(k{fmt}, {fmt}Format)" in lay
    for src in (b1, lay):
        assert "__global__" not in src and "copy_plane" not in src

"""The shared-stream kernels D4 and D5 (entropy_coders_tpu_torch/csrc/
fse_coder.cu), run on the CPU, and the wrappers around them.

The kernels, cut from the file at the host launchers, compile with g++
against ``tests/cuda_emu/cuda_runtime.h`` (one std::thread per CUDA thread,
a barrier per warp for the shuffles, ``atomicOr``/``atomicMin`` as
``std::atomic_ref`` operations, ``__syncthreads_or`` a vote between
barriers), a ``lane_launch.cuh`` whose ``cp.async`` is a copy at once, and
``tests/cuda_emu/fse_coder_main.cpp`` (blocks one after the other; the test
names the kernel: D5's one-thread one (up to 2 lanes), a one-warp one (up
to 32) or a wide one, whose lanes a thread and CTA are the launch rule's,
and may shrink the wide kernels' rings and D4's sub-rounds). Every kernel
runs on every case it takes. The same numpy inputs, made from a seed, go through the emulated
kernels, the plain versions (``ops.coder.encode_core_ref``/
``decode_core_ref``) and the JAX package's ``_encode_core``/
``_decode_core``: clean streams at k in {1, 2, 3, 5, 8, 9, 32, 33, 64,
100, 130} (2 / 3 and 32 / 33 on either side of the launch rule's
thresholds; the wide kernels at one and two lanes a thread) and table logs 5, 9, 11, 12, 15,
padding slots, two blocks with different tables, and corrupted and
truncated words, where ``done``, ``emit_count``, the failed lane's finals
and the cursor must match. D5's wide kernel also runs with a ring of 4
words (most rounds read device memory, every refill wraps), D4's wide
kernel in sub-rounds of 32 threads with the smallest ring they allow. With
an error word (``utils.checked``), the first failed check the kernels
record gives the plain checked version's ValueError message. What the
emulation cannot show: timing, the order of the asynchronous copies, and
anything the card's compiler refuses; chip_smoke.py (phase
``shared_stream``) holds the built kernels against the same plain versions
on the card.

Then the wrappers: CPU tensors run the plain versions; CUDA tensors go to
the kernels and raise when the library cannot load (no fallback); and
``lanes=False`` frames at k in {1, 2, 3, 100, 1024} equal the JAX
package's.

Tolerance: exact."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu import frame as JF  # noqa: E402
from entropy_coders_tpu.ops import coder as JC  # noqa: E402
from entropy_coders_tpu_torch import frame as F  # noqa: E402
from entropy_coders_tpu_torch import native  # noqa: E402
from entropy_coders_tpu_torch.kernels import build as KB  # noqa: E402
from entropy_coders_tpu_torch.ops import coder as C  # noqa: E402
from entropy_coders_tpu_torch.ops import tables as TB  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import to_device  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "entropy_coders_tpu_torch" / "csrc" / "fse_coder.cu"
EMU = Path(__file__).resolve().parent / "cuda_emu"


# lane_launch.cuh's device helpers in C: a cp.async lands at once
LANE_LAUNCH = """#pragma once
#include <cstdint>
#include <cstring>
namespace ect_lane {
inline void cp_async4(void* smem, const void* gmem) { std::memcpy(smem, gmem, 4); }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
}  // namespace ect_lane
"""


def emulated_source(src: str) -> str:
    """fse_coder.cu's device code with its dynamic shared memory taken
    from the emulator."""
    src = src[: src.index("// --- host launchers ---")]
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu_dyn_smem;")
    if "asm" in src or "extern __shared__" in src:
        raise AssertionError("PTX or extern shared memory left in the "
                             "emulated source")
    return src


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulation")
    out = tmp_path_factory.mktemp("fse_coder_emu")
    (out / "lane_launch.cuh").write_text(LANE_LAUNCH)
    (out / "fse_coder_kernels.cu").write_text(
        emulated_source(SRC.read_text()))
    lib = out / "libfse_coder_emu.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{out}", f"-I{EMU}", "-o", str(lib),
         str(EMU / "fse_coder_main.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.emu_fse_decode.argtypes = [P] * 9 + [I, LL, I, I, I, I, I, I, I]
    dll.emu_fse_encode.argtypes = [P] * 10 + [I, I, I, I, I, LL, I, I, I]
    return dll


def ptr(a: np.ndarray):
    return a.ctypes.data


# --- inputs ------------------------------------------------------------------


def norm_tables(rng, B: int, L: int, alphabet: int) -> np.ndarray:
    """B valid normalizations to 2^L slots over ``alphabet`` symbols (a
    random subset of the 256, a few of them -1), each block its own."""
    size = 1 << L
    a = min(alphabet, size)
    nt = np.zeros((B, 256), np.int32)
    for b in range(B):
        sym = rng.choice(256, a, replace=False)
        counts = 1 + rng.multinomial(size - a, rng.dirichlet(np.ones(a)))
        low = rng.random(a) < 0.1
        counts[low & (counts == 1)] = -1
        nt[b, sym] = counts
    return TB.check_norm_tables(nt, L)


def blocks_for(rng, nt: np.ndarray, n: int) -> np.ndarray:
    """One row of n bytes a block, drawn from its table's symbols."""
    out = np.empty((nt.shape[0], n), np.uint8)
    for b, row in enumerate(nt):
        p = np.where(row == -1, 1, row).astype(np.float64)
        out[b] = rng.choice(256, n, p=p / p.sum())
    return out


class Case:
    """One group's encode inputs (numpy), with their tables."""

    def __init__(self, seed, B, n, k, L, alphabet):
        rng = np.random.default_rng(seed)
        self.k, self.L = k, L
        self.nt = norm_tables(rng, B, L, alphabet)
        self.blocks = blocks_for(rng, self.nt, n)
        self.m, self.R, self.valid, self.finish, self.W = C.encode_layout(n,
                                                                          k)
        syms, init = C.blocks_to_syms(self.blocks, self.m, self.R, k)
        self.syms = np.ascontiguousarray(syms)
        self.init = np.ascontiguousarray(init)
        self.table, self.tt_bits, self.tt_fs = native.build_encode_tables(
            self.nt, L)
        self.packed = native.build_decode_tables(self.nt, L)

    def torch_tables(self, table=None):
        return (to_device(self.table if table is None else table, "cpu"),
                to_device(self.tt_bits, "cpu"), to_device(self.tt_fs, "cpu"))

    def ref_encode(self, table=None, W=None, checked=False):
        return C.encode_core_ref(
            torch.from_numpy(self.syms), torch.from_numpy(self.valid),
            torch.from_numpy(self.init), torch.from_numpy(self.finish),
            self.torch_tables(table), k=self.k, L=self.L, W=W or self.W,
            checked=checked)


def emu_encode(dll, c: Case, table=None, W=None, checked=False, path=-1,
               ring=0, sub=0):
    """D4 in the emulator: (words (B, W) u32, total_bits (B,), err).
    ``path`` -1 takes the launch rule's kernel, 2 the one-warp one, 1 the
    wide one; ``ring``/``sub`` 0 the launcher's ring and sub-round."""
    table = np.ascontiguousarray(c.table if table is None else table)
    W = W or c.W
    B, R, k = c.syms.shape
    words = np.full((B, W), 0xABABABAB, np.uint32)  # every word written
    total = np.full(B, -5, np.int64)
    err = np.full(B, -1, np.int64)
    valid = c.valid.astype(np.uint8)
    assert dll.emu_fse_encode(
        ptr(c.syms), ptr(valid), ptr(c.init), ptr(c.finish), ptr(table),
        ptr(c.tt_bits), ptr(c.tt_fs), ptr(words), ptr(total),
        ptr(err) if checked else None, B, R, k, c.L, table.shape[1], W,
        path, ring, sub) == 0
    return words, total, err


def emu_decode(dll, words, total, packed, k, L, R, path=-1, checked=False,
               ring=0, group=0):
    """D5 in the emulator: (syms, emit, finals, done, cursor, err); ``path``
    and ``ring`` as for ``emu_encode``, ``group`` the one-thread kernel's
    blocks a CTA (0: the launcher's)."""
    words = np.ascontiguousarray(words, np.uint32)
    total = np.ascontiguousarray(total, np.int64)
    packed = np.ascontiguousarray(packed, np.uint32)
    B, Wd = words.shape
    syms = np.full((B, R, k), 0xAB, np.uint8)
    emit = np.full(B, -5, np.int64)
    finals = np.full((B, k), 0xAB, np.uint8)
    done = np.full(B, 7, np.uint8)
    cursor = np.full(B, -5, np.int64)
    err = np.full(B, -1, np.int64)
    assert dll.emu_fse_decode(
        ptr(words), ptr(total), ptr(packed), ptr(syms), ptr(emit),
        ptr(finals), ptr(done), ptr(cursor), ptr(err) if checked else None,
        B, Wd, k, L, packed.shape[1], R, path, ring, group) == 0
    return syms, emit, finals, done.astype(bool), cursor, err


def decode_kernels(k: int):
    """D5's kernels (path numbers) that take k lanes: the one-thread one (0)
    up to 2 lanes, the one-warp one (2) up to 32, the wide one (1) always."""
    return [p for p, top in ((0, 2), (2, 32), (1, 1 << 16)) if k <= top]


def encode_kernels(k: int):
    """D4's kernels that take k lanes: the one-warp one (2) up to 32 lanes,
    the wide one (1) always."""
    return [p for p, top in ((2, 32), (1, 1 << 16)) if k <= top]


def ref_decode(words, total, packed, k, L, R, checked=False):
    out = C.decode_core_ref(to_device(np.asarray(words, np.uint32), "cpu"),
                            torch.from_numpy(np.asarray(total, np.int64)),
                            to_device(np.asarray(packed, np.uint32), "cpu"),
                            k=k, L=L, R=R, checked=checked)
    return [t.numpy() for t in out]


def jax_encode(c: Case):
    out = [JC._encode_core(c.syms[b], c.valid, c.init[b],
                           c.finish.astype(np.int32), c.tt_bits[b],
                           c.tt_fs[b], c.table[b], k=c.k, L=c.L, W=c.W)
           for b in range(c.syms.shape[0])]
    return (np.stack([np.asarray(w) for w, _ in out]),
            np.array([int(t) for _, t in out]))


def jax_decode(words, total, packed, k, L, R):
    outs = [JC._decode_core(words[b], np.int32(total[b]), packed[b], k=k,
                            L=L, R=R) for b in range(words.shape[0])]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(5)]


def assert_decodes_equal(got, want, what):
    names = ("syms", "emit_count", "finals", "done", "cursor")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=f"{what}: {name}")


def decode_inputs(words_u32, total):
    """The decode's view of an encode: two more zero guard words, the start
    at the marker bit (as ``decode_interleaved`` and the container do)."""
    B = words_u32.shape[0]
    return (np.concatenate([words_u32, np.zeros((B, 2), np.uint32)], 1),
            np.asarray(total, np.int64) - 1)


# --- D4 and D5 against the plain versions and JAX ----------------------------

# (k, L, n, B, alphabet): D5's one-thread kernel at both its widths (1,
# 2), the one-warp kernels from 1 to 32 lanes, the launch rule's
# thresholds on either side (D5: 2 one-thread, 3 one-warp; both: 32
# one-warp, 33 wide), the wide kernels at one lane a thread (32: a warp,
# 33: two, 64, 100: four) and two (130, three warps of 65 threads' lanes);
# n - k not a multiple of k (padding slots) in all but the k=64 case
CASES = [(1, 12, 203, 2, 40), (2, 9, 301, 2, 256), (3, 5, 200, 2, 12),
         (5, 11, 5 * 40 + 3, 2, 100), (8, 11, 8 * 30 + 5, 2, 200),
         (9, 10, 9 * 25 + 4, 2, 200), (32, 12, 32 * 12 + 5, 2, 256),
         (33, 15, 33 * 9 + 7, 2, 256),
         (64, 9, 64 * 6, 2, 100), (100, 12, 100 * 4 + 37, 1, 256),
         (130, 11, 130 * 3 + 1, 2, 256)]


@pytest.mark.parametrize("k,L,n,B,alphabet", CASES,
                         ids=[f"k{c[0]}L{c[1]}" for c in CASES])
def test_kernels_equal_plain_and_jax(emu, k, L, n, B, alphabet):
    c = Case(1000 * k + L, B, n, k, L, alphabet)
    rwords, rtotal = c.ref_encode()
    jwords, jtotal = jax_encode(c)
    np.testing.assert_array_equal(rwords.numpy(), jwords.astype(np.int64))
    np.testing.assert_array_equal(rtotal.numpy(), jtotal)
    for path in encode_kernels(k):
        words, total, _ = emu_encode(emu, c, path=path)
        np.testing.assert_array_equal(words, jwords, err_msg=f"D4 {path}")
        np.testing.assert_array_equal(total, jtotal, err_msg=f"D4 {path}")

    dw, dt = decode_inputs(jwords, jtotal)
    R = c.R + 1
    want = ref_decode(dw, dt, c.packed, k, L, R)
    assert_decodes_equal(want, jax_decode(dw, dt, c.packed, k, L, R),
                         "plain vs JAX")
    runs = [(path, 0, 0) for path in decode_kernels(k)] + [(1, 4, 0)]
    if k <= 2:  # the one-thread kernel a block a CTA too
        runs.append((0, 0, 1))
    for path, ring, group in runs:
        got = emu_decode(emu, dw, dt, c.packed, k, L, R, path=path,
                         ring=ring, group=group)
        assert_decodes_equal(got[:5], want, f"D5 {path} ring {ring} group "
                             f"{group}")
    syms, emit, finals, done, cursor, _ = got
    assert done.all() and (emit == c.m).all() and (cursor >= 0).all()
    back = np.concatenate([syms.reshape(B, -1)[:, : c.m], finals], 1)
    np.testing.assert_array_equal(back, c.blocks)


@pytest.mark.parametrize("k", [130, 300], ids=["J2", "J4"])
def test_encode_rings_and_sub_rounds(emu, k):
    """D4 wide's result does not depend on how a round is emitted: its
    launcher's ring and sub-round, and sub-rounds of 32 threads with the
    smallest ring they allow (a round in three or three and a bit
    sub-rounds, the ring wrapping every few of them), at two and four lanes
    a thread; D5 wide at the same k, with its ring and with 4 words."""
    c = Case(7 + k, 2, k * 4 + 9, k, 11, 256)
    want, wtotal = c.ref_encode()
    J = emu.emu_fse_wide_lanes(k)
    for sub, ring in ((0, 0), (32, emu.emu_fse_encode_ring(32, J, c.L))):
        words, total, _ = emu_encode(emu, c, path=1, ring=ring, sub=sub)
        np.testing.assert_array_equal(words.astype(np.int64), want.numpy(),
                                      err_msg=f"sub {sub}")
        np.testing.assert_array_equal(total, wtotal.numpy())
    dw, dt = decode_inputs(want.numpy().astype(np.uint32), wtotal.numpy())
    R = c.R + 1
    ref = ref_decode(dw, dt, c.packed, k, c.L, R)
    for ring in (0, 4):
        got = emu_decode(emu, dw, dt, c.packed, k, c.L, R, path=1, ring=ring)
        assert_decodes_equal(got[:5], ref, f"D5 ring {ring}")


@pytest.mark.parametrize("k,L", [(1, 11), (2, 9), (3, 12)],
                         ids=["k1", "k2", "k3"])
def test_one_thread_kernels_across_tiles(emu, k, L):
    """The one-thread and one-warp kernels over many of their tiles (512
    slots a tile: each tile's words staged from the cursor at the tile
    before, its symbols stored and its bits packed a tile later): clean,
    truncated (the stream ends inside a later tile) and flipped words,
    against the plain versions."""
    c = Case(300 + k, 2, 2900 + k, k, L, 256)
    want, wtotal = c.ref_encode()
    words, total, _ = emu_encode(emu, c, path=2)
    np.testing.assert_array_equal(words.astype(np.int64), want.numpy())
    np.testing.assert_array_equal(total, wtotal.numpy())
    dw, dt = decode_inputs(words, total)
    R = c.R + 1
    flipped = dw.copy()
    flipped[:, 5] ^= np.uint32(1 << 9)
    for what, ww, tt in (("clean", dw, dt), ("truncated", dw, dt - 2000),
                         ("flipped", flipped, dt)):
        for path in decode_kernels(k)[:-1]:
            got = emu_decode(emu, ww, tt, c.packed, k, L, R, path=path)
            assert_decodes_equal(got[:5],
                                 ref_decode(ww, tt, c.packed, k, L, R),
                                 f"{what}, kernel {path}")


# corrupt streams: (what, how the words / start change)
CORRUPT = ["flip", "flip_many", "truncated", "zeroed_top", "short",
           "past_words", "marker_off"]


@pytest.mark.parametrize("how", CORRUPT)
@pytest.mark.parametrize("k,L", [(1, 12), (2, 9), (33, 15), (64, 9)],
                         ids=["k1", "k2", "k33", "k64"])
def test_decode_corrupt_equals_plain(emu, how, k, L):
    """Corrupted and truncated words: the five outputs equal the plain
    version's (and JAX's) bit for bit, the failed lane and the cursor
    included, since ``decode_interleaved``'s None / ValueError and the
    container's checks read them. Every kernel that takes k runs, the wide
    one also with a ring of 4 words."""
    n = {1: 203, 2: 301, 33: 33 * 9 + 7, 64: 64 * 6}[k]
    c = Case(77 * k + L, 2, n, k, L, 256)
    dw, dt = decode_inputs(*c.ref_encode()[:2])
    dw = dw.astype(np.uint32)
    rng = np.random.default_rng(len(how) + k)
    nbits = int(dt.max())
    if how == "flip":
        for b in range(2):
            bit = int(rng.integers(0, int(dt[b])))
            dw[b, bit >> 5] ^= np.uint32(1 << (bit & 31))
    elif how == "flip_many":
        dw ^= (rng.random(dw.shape) < 0.05).astype(np.uint32) << np.uint32(7)
    elif how == "truncated":
        dt = dt - nbits // 3
    elif how == "zeroed_top":
        dw[:, (nbits // 64):] = 0
    elif how == "short":
        dt = np.array([k * L - 1, 3], np.int64)
    elif how == "past_words":
        dt = dt + 32 * dw.shape[1] + 5
    else:
        dt = dt + 1
    R = c.R + 1
    want = ref_decode(dw, dt, c.packed, k, L, R)
    assert_decodes_equal(want, jax_decode(dw, dt, c.packed, k, L, R),
                         f"{how}: plain vs JAX")
    for path, ring in [(p, 0) for p in decode_kernels(k)] + [(1, 4)]:
        got = emu_decode(emu, dw, dt, c.packed, k, L, R, path=path,
                         ring=ring)
        assert_decodes_equal(got[:5], want, f"{how}, kernel {path}, ring "
                             f"{ring}: emulated vs plain")


# --- the error word (utils.checked) ------------------------------------------


def plain_message(fn) -> str | None:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def kernel_message(err, name_of) -> str | None:
    try:
        C._check_error(torch.from_numpy(err), name_of)
    except ValueError as e:
        return str(e)
    return None


ENCODE_ERRORS = ["clean", "small_table", "few_words"]


@pytest.mark.parametrize("what", ENCODE_ERRORS)
def test_encode_error_word(emu, what):
    c = Case(5, 2, 301, 3, 10, 64)
    table = c.table[:, :256].copy() if what == "small_table" else None
    W = 4 if what == "few_words" else c.W
    want = plain_message(lambda: c.ref_encode(table=table, W=W,
                                              checked=True))
    assert (want is None) == (what == "clean")
    size = c.table.shape[1] if table is None else table.shape[1]
    # the unchecked outputs are the checked launch's too: clamped, as JAX
    rwords, rtotal = c.ref_encode(table=table, W=W)
    for path in encode_kernels(c.k):
        words, total, err = emu_encode(emu, c, table=table, W=W,
                                       checked=True, path=path)
        got = kernel_message(err, lambda s: C._encode_check(s, c.R, size, W))
        assert got == want, f"kernel {path}"
        np.testing.assert_array_equal(words.astype(np.int64), rwords.numpy())
        np.testing.assert_array_equal(total, rtotal.numpy())


DECODE_ERRORS = ["clean", "past_words", "short", "small_table"]


@pytest.mark.parametrize("what", DECODE_ERRORS)
@pytest.mark.parametrize("k", [3, 33], ids=["k3", "k33"])
def test_decode_error_word(emu, what, k):
    L = 10
    c = Case(9, 2, k * 7 + 5, k, L, 200)
    dw, dt = decode_inputs(*c.ref_encode()[:2])
    packed = c.packed
    if what == "past_words":
        dt = dt + 32 * dw.shape[1]
    elif what == "short":
        dt = dt.copy()
        dt[1] = k * L - 40
    elif what == "small_table":
        packed = packed[:, : 1 << (L - 1)].copy()
    R = c.R + 1
    want = plain_message(lambda: ref_decode(dw, dt, packed, k, L, R,
                                            checked=True))
    assert (want is None) == (what == "clean")
    size, Wd = packed.shape[1], dw.shape[1]
    for path in decode_kernels(k):
        got = emu_decode(emu, dw, dt, packed, k, L, R, path=path,
                         checked=True)
        assert kernel_message(got[5], lambda s: C._decode_check(s, size,
                                                                Wd)) == want
        if what != "small_table":  # the plain unchecked decode clamps these
            assert_decodes_equal(got[:5], ref_decode(dw, dt, packed, k, L, R),
                                 f"{what}, kernel {path}")


# --- the wrappers ------------------------------------------------------------


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    c = Case(3, 1, 90, 4, 9, 30)
    calls = []

    def spy(name, real):
        def fn(*args, **kwargs):
            calls.append((name, kwargs.get("checked")))
            return real(*args, **kwargs)
        return fn

    monkeypatch.setattr(C, "encode_core_ref",
                        spy("encode", C.encode_core_ref))
    monkeypatch.setattr(C, "decode_core_ref",
                        spy("decode", C.decode_core_ref))
    before = (C.ENCODE_LAUNCHES, C.DECODE_LAUNCHES)
    words, total = C.encode_core(
        torch.from_numpy(c.syms), torch.from_numpy(c.valid),
        torch.from_numpy(c.init), torch.from_numpy(c.finish),
        c.torch_tables(), k=4, L=9, W=c.W, checked=True)
    dw, dt = decode_inputs(words.numpy().astype(np.uint32), total.numpy())
    out = C.decode_core(to_device(dw, "cpu"), torch.from_numpy(dt),
                        to_device(c.packed, "cpu"), k=4, L=9, R=c.R + 1)
    assert calls == [("encode", True), ("decode", False)]
    assert (C.ENCODE_LAUNCHES, C.DECODE_LAUNCHES) == before
    assert bool(out[3].all()) and int(out[1][0]) == c.m


class OnCuda(torch.Tensor):
    """A meta tensor that says it lies on the card: the wrappers' device
    rule without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def on_cuda(a: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    t = t if dtype is None else t.view(dtype)
    return torch.empty(t.shape, dtype=t.dtype, device="meta").as_subclass(
        OnCuda)


def test_cuda_tensors_launch_or_raise(monkeypatch):
    """On a CUDA tensor the wrappers take the kernels' library or raise
    its error: the plain versions never run there."""
    c = Case(3, 1, 90, 4, 9, 30)

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    def no_library():
        raise RuntimeError("the kernels' library did not build")

    monkeypatch.setattr(C, "encode_core_ref", no_plain)
    monkeypatch.setattr(C, "decode_core_ref", no_plain)
    monkeypatch.setattr(KB, "load", no_library)
    tables = (on_cuda(c.table.view(np.int16), torch.uint16),
              on_cuda(c.tt_bits.view(np.int32), torch.uint32),
              on_cuda(c.tt_fs))
    with pytest.raises(RuntimeError, match="did not build"):
        C.encode_core(on_cuda(c.syms), on_cuda(c.valid), on_cuda(c.init),
                      on_cuda(c.finish), tables, k=4, L=9, W=c.W)
    words = np.zeros((1, c.W + 2), np.int32)
    with pytest.raises(RuntimeError, match="did not build"):
        C.decode_core(on_cuda(words, torch.uint32),
                      on_cuda(np.zeros(1, np.int64)),
                      on_cuda(c.packed.view(np.int32), torch.uint32),
                      k=4, L=9, R=c.R + 1, checked=True)
    # a wrong type is refused before any launch
    with pytest.raises(ValueError, match="dtype"):
        C.decode_core(on_cuda(words), on_cuda(np.zeros(1, np.int64)),
                      on_cuda(c.packed.view(np.int32), torch.uint32),
                      k=4, L=9, R=c.R + 1)


def test_meta_device_is_refused():
    c = Case(3, 1, 90, 4, 9, 30)
    meta = torch.empty((1, c.W), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        C.decode_core(meta, meta[:, 0], meta, k=4, L=9, R=3)


# --- lanes=False frames against the JAX package ------------------------------

# k -> (block size, input size): full blocks and a ragged tail
FRAMES = {1: (2048, 2 * 2048 + 333), 2: (4096, 2 * 4096 + 1000),
          3: (1024, 3 * 1024 + 100), 100: (4096, 2 * 4096 + 777),
          1024: (4096, 2 * 4096 + 2500)}


@pytest.mark.parametrize("k", list(FRAMES))
def test_shared_stream_frames_match_jax(k):
    bs, size = FRAMES[k]
    data = gen_sequence(0.25, size, seed=40 + k)
    kw = dict(block_size=bs, k=k, lanes=False)
    frame = F.compress(data, device="cpu", **kw)
    assert frame == JF.compress(data, **kw)
    pf = F._parse_frame(frame)
    assert (pf.modes == F.MODE_FSE).all()
    assert F.decompress(frame, device="cpu") == data.tobytes()


def test_shared_stream_pins_match_the_port():
    """``tests/shared_stream_pins.py``, which makes chip_smoke.py's pinned
    JAX frames (``SHARED_STREAM``), gives the port's frames at a small
    size: one 128 KiB block and a ragged tail, at both points' knobs."""
    import hashlib

    import chip_smoke
    from tests import shared_stream_pins as SP

    size = 128 * 1024 + 777
    got = SP.pins(size)
    data = chip_smoke.load_testdata().gen_sequence(0.2, size,
                                                  chip_smoke.BENCH_SEED)
    for name, (knobs, _, _) in chip_smoke.SHARED_STREAM.items():
        frame = F.compress(data, device="cpu", **knobs)
        assert got[name] == (len(frame), hashlib.sha256(frame).hexdigest())


# --- the launchers' C interface ----------------------------------------------


def c_params(src: str, fn: str) -> list:
    """The parameter types of ``extern "C" int fn(...)`` in ``src``, as
    ctypes would take them: a pointer or the stream (c_void_p), an int, a
    long long."""
    head = src[src.index(f'extern "C" int {fn}('):]
    params = head[head.index("(") + 1: head.index(")")].split(",")
    kinds = []
    for p in params:
        p = " ".join(p.split())
        kinds.append(ctypes.c_void_p if "*" in p or "cudaStream_t" in p
                     else ctypes.c_longlong if "long long" in p
                     else ctypes.c_int)
    return kinds


@pytest.mark.parametrize("fn", ["ect_fse_decode", "ect_fse_encode",
                                "ect_fse_decode_path", "ect_fse_encode_path",
                                "ect_fse_launch_info"])
def test_launcher_signatures_match_the_source(fn):
    """``kernels.build``'s ctypes signature of each D4/D5 launcher is the
    one fse_coder.cu declares (a pointer passed as an int would be cut to
    32 bits, a long long as an int misread)."""
    assert KB._SIGNATURES[fn] == c_params(SRC.read_text(), fn)


def test_sass_round_loop_finds_the_loop():
    """chip_smoke's ``sass_round_loop`` on a listing of two loops, one
    nested, in both branch forms: the innermost loop that holds the named
    ops, counted whole."""
    import chip_smoke

    text = """
        Function : _ZN12_GLOBAL__N_114fse_decode_wideILi8ELb0EEEvPKj
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS R2, [R3] ;
.L_x_1:
        /*0020*/                   SHFL.UP PT, R4, R2, 0x1, RZ ;
        /*0030*/                   IADD3 R4, R4, R2, RZ ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/               @P0 BRA 0x20 ;
        /*0060*/                   IADD3 R5, R5, 0x1, RZ ;
        /*0070*/               @P1 BRA `(.L_x_1) ;
        /*0080*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_114other
    """
    got = chip_smoke.sass_round_loop(text, "decode", 1, 8)
    assert got["found"] and got["instructions"] == 4
    assert dict(got["top_ops"])["SHFL"] == 1
    assert not chip_smoke.sass_round_loop(text, "decode", 1, 16)["found"]

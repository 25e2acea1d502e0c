"""The shared-stream kernels D4 and D5 (entropy_coders_tpu_torch/csrc/
fse_coder.cu), run on the CPU, and the wrappers around them.

The kernels, cut from the file at the host launchers, compile with g++
against ``tests/cuda_emu/cuda_runtime.h`` (one std::thread per CUDA thread,
a barrier per warp for the shuffles, ``atomicOr``/``atomicMin`` as
``std::atomic_ref`` operations) and ``tests/cuda_emu/fse_coder_main.cpp``
(blocks one after the other; D5's lanes a thread and D4's CTA sizes picked
by the test, so that a case stays a few warps wide). The same numpy inputs,
made from a seed, go through the emulated kernels, the plain versions
(``ops.coder.encode_core_ref``/``decode_core_ref``) and the JAX package's
``_encode_core``/``_decode_core``: clean streams at k in {1, 2, 3, 5, 33,
64, 100, 130} (one warp of threads up to 32 lanes at one lane a thread,
then one to three warps) and table logs 5, 9, 11, 12, 15, padding slots,
two blocks
with different tables, and corrupted and truncated words, where ``done``,
``emit_count``, the failed lane's finals and the cursor must match. With
an error word (``utils.checked``), the first failed check the kernels
record gives the plain checked version's ValueError message. What the
emulation cannot show: timing and anything the card's compiler refuses;
chip_smoke.py (phase ``shared_stream``) holds the built kernels against
the same plain versions on the card.

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
    (out / "fse_coder_kernels.cu").write_text(
        emulated_source(SRC.read_text()))
    lib = out / "libfse_coder_emu.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         f"-I{EMU}", f"-I{out}", "-o", str(lib),
         str(EMU / "fse_coder_main.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.emu_fse_decode.argtypes = [P] * 10 + [I, LL, I, I, I, I, I]
    dll.emu_fse_encode.argtypes = [P] * 13 + [I, I, I, I, I, LL, I, I]
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


def emu_encode(dll, c: Case, table=None, W=None, checked=False,
               chain_T=32, pack_T=32):
    """D4 in the emulator: (words (B, W) u32, total_bits (B,), err)."""
    table = np.ascontiguousarray(c.table if table is None else table)
    W = W or c.W
    B, R, k = c.syms.shape
    words = np.full((B, W), 0xABABABAB, np.uint32)  # every word written
    total = np.full(B, -5, np.int64)
    err = np.full(B, -1, np.int64)
    sbits = np.full((B, R, k), 0xAB, np.uint8)
    svals = np.full((B, R, k), 0xABAB, np.uint16)
    fstate = np.full((B, k), -7, np.int32)
    valid = c.valid.astype(np.uint8)
    assert dll.emu_fse_encode(
        ptr(c.syms), ptr(valid), ptr(c.init), ptr(c.finish), ptr(table),
        ptr(c.tt_bits), ptr(c.tt_fs), ptr(words), ptr(total),
        ptr(err) if checked else None, ptr(sbits), ptr(svals), ptr(fstate),
        B, R, k, c.L, table.shape[1], W, chain_T, pack_T) == 0
    return words, total, err


def emu_decode(dll, words, total, packed, k, L, R, J=None, checked=False):
    """D5 in the emulator: (syms, emit, finals, done, cursor, err). ``J``
    None takes the launcher's pick of lanes a thread; a J names it."""
    J = J or dll.emu_decode_lanes_per_thread(k)
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
    fstate = np.full((B, k), -7, np.int32)
    assert dll.emu_fse_decode(
        ptr(words), ptr(total), ptr(packed), ptr(syms), ptr(emit),
        ptr(finals), ptr(done), ptr(cursor), ptr(err) if checked else None,
        ptr(fstate), B, Wd, k, L, packed.shape[1], R, J) == 0
    return syms, emit, finals, done.astype(bool), cursor, err


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

# (k, L, n, B, alphabet) and D5's lanes a thread (None: the launcher's
# pick, one lane a thread); one to three warps of threads, one lane a
# thread and two or four; n - k not a multiple of k (padding slots) in all
# but the k=64 case
CASES = [(1, 12, 203, 2, 40), (2, 9, 301, 2, 256), (3, 5, 200, 2, 12),
         (5, 11, 5 * 40 + 3, 2, 100), (33, 15, 33 * 9 + 7, 2, 256),
         (64, 9, 64 * 6, 2, 100), (100, 12, 100 * 4 + 37, 1, 256),
         (130, 11, 130 * 3 + 1, 2, 256)]
LANES = {1: None, 2: None, 3: None, 5: None, 33: 2, 64: 1, 100: 4, 130: 2}


@pytest.mark.parametrize("k,L,n,B,alphabet", CASES,
                         ids=[f"k{c[0]}L{c[1]}" for c in CASES])
def test_kernels_equal_plain_and_jax(emu, k, L, n, B, alphabet):
    c = Case(1000 * k + L, B, n, k, L, alphabet)
    words, total, _ = emu_encode(emu, c)
    rwords, rtotal = c.ref_encode()
    np.testing.assert_array_equal(words.astype(np.int64), rwords.numpy())
    np.testing.assert_array_equal(total, rtotal.numpy())
    jwords, jtotal = jax_encode(c)
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_array_equal(total, jtotal)

    dw, dt = decode_inputs(words, total)
    R = c.R + 1
    got = emu_decode(emu, dw, dt, c.packed, k, L, R, J=LANES[k])
    assert_decodes_equal(got[:5], ref_decode(dw, dt, c.packed, k, L, R),
                         "emulated vs plain")
    assert_decodes_equal(got[:5], jax_decode(dw, dt, c.packed, k, L, R),
                         "emulated vs JAX")
    syms, emit, finals, done, cursor, _ = got
    assert done.all() and (emit == c.m).all() and (cursor >= 0).all()
    back = np.concatenate([syms.reshape(B, -1)[:, : c.m], finals], 1)
    np.testing.assert_array_equal(back, c.blocks)


@pytest.mark.parametrize("T", [(32, 32), (64, 128)], ids=["T32", "T64-128"])
def test_encode_cta_sizes(emu, T):
    """D4's result does not depend on its CTA sizes: lane chunks of 32 or
    64 threads, 32 or 128 threads packing (tiles of 256 or 1,024 slots, so
    that a block spans several tiles and their carried words)."""
    c = Case(7, 2, 130 * 4 + 9, 130, 11, 256)
    want, wtotal = c.ref_encode()
    words, total, _ = emu_encode(emu, c, chain_T=T[0], pack_T=T[1])
    np.testing.assert_array_equal(words.astype(np.int64), want.numpy())
    np.testing.assert_array_equal(total, wtotal.numpy())


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
    container's checks read them."""
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
    # the launcher's pick, and at k = 2 one thread holding both lanes
    for J in {1: (None,), 2: (None, 2), 33: (2,), 64: (1,)}[k]:
        got = emu_decode(emu, dw, dt, c.packed, k, L, R, J=J)
        assert_decodes_equal(got[:5], want, f"{how}, J={J}: emulated vs "
                             f"plain")


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
    words, total, err = emu_encode(emu, c, table=table, W=W, checked=True)
    want = plain_message(lambda: c.ref_encode(table=table, W=W,
                                              checked=True))
    size = c.table.shape[1] if table is None else table.shape[1]
    got = kernel_message(err, lambda s: C._encode_check(s, c.R, size, W))
    assert got == want
    assert (want is None) == (what == "clean")
    # the unchecked outputs are the checked launch's too: clamped, as JAX
    rwords, rtotal = c.ref_encode(table=table, W=W)
    np.testing.assert_array_equal(words.astype(np.int64), rwords.numpy())
    np.testing.assert_array_equal(total, rtotal.numpy())


DECODE_ERRORS = ["clean", "past_words", "short", "small_table"]


@pytest.mark.parametrize("what", DECODE_ERRORS)
@pytest.mark.parametrize("k,J", [(3, None), (33, 2)], ids=["k3", "k33"])
def test_decode_error_word(emu, what, k, J):
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
    got = emu_decode(emu, dw, dt, packed, k, L, R, J=J, checked=True)
    want = plain_message(lambda: ref_decode(dw, dt, packed, k, L, R,
                                            checked=True))
    size, Wd = packed.shape[1], dw.shape[1]
    assert kernel_message(got[5], lambda s: C._decode_check(s, size,
                                                            Wd)) == want
    assert (want is None) == (what == "clean")
    if what != "small_table":  # the plain unchecked decode clamps these
        assert_decodes_equal(got[:5], ref_decode(dw, dt, packed, k, L, R),
                             what)


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

"""Randomized differential fuzz of the port (``entropy_coders_tpu_torch``)
against the JAX package, the port's counterpart of ``tests/fuzz_diff.py``.

The fixed tests pin chosen points; this samples the input and
configuration space at random and holds the port to the JAX package on
each sample, byte for byte, in four legs:

  reference   ``native.compress`` of the port equals ``spec``'s
              ``fse_compress`` for random data at k in {1, 2, 3, 5}, and
              each decodes the other's frame (a degenerate input raises
              ValueError in both);
  container   ``frame.compress(device="cpu")`` of the port equals the JAX
              ``frame.compress(interpret=True)`` under random block size,
              k, ``lanes``, ``bit_pack``, ``checksum``, ``shared_table``
              and ``table_log`` (None, "auto", "fast", ints); each package
              decodes the other's frame, and a random range decode agrees;
  lanes       ``ops.encode_lanes``/``decode_lanes`` (``device="cpu"``)
              equal the JAX entries at random (B, k, L, R), weighted to
              L >= 10 and R % 3 == 2, the tables given stacked or as rows
              at random; the blocks' FLAG_PACKED lane-size tables pack and
              unpack as the JAX package's do, and on samples whose lanes
              are made to sit at the size table's edges (every lane the
              same size, sizes below 256, sizes spread wide) both packages
              write the same bit-packed frame and read each other's;
  corruption  byte flips in the frame and histogram header region (as
              ``tests/test_robustness.py::test_corrupt_headers_fuzz``) and
              anywhere in a lane frame: the port's
              ``decompress(device="cpu")`` raises ValueError or returns
              bytes, nothing else, and within a time bound.

Every failure names its (seed, iteration). Each distinct shape is a fresh
JAX trace (the interpret-mode Pallas kernels compile for seconds), so the
pytest samples a narrow palette with a small fixed budget and seed; the
soak samples the full space with ``--wide``:

    python tests/test_torch_fuzz_diff.py --iters 2000 [--seed S] [--wide]
        [--legs reference,container,lanes,corruption]
"""

from __future__ import annotations

import os
import sys
import time
from collections import Counter

# script mode puts tests/ on sys.path, not the repo root with the packages
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":  # before jax is imported: the CPU backend
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from entropy_coders_tpu import frame as JF  # noqa: E402
from entropy_coders_tpu.ops import pl_coder as JPL  # noqa: E402
from entropy_coders_tpu.spec.codec import fse_compress, fse_decompress  # noqa: E402
from entropy_coders_tpu_torch import frame as PF  # noqa: E402
from entropy_coders_tpu_torch import native  # noqa: E402
from entropy_coders_tpu_torch import ops  # noqa: E402
from entropy_coders_tpu_torch.normalize import normalize_batch  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import to_numpy  # noqa: E402

LEGS = ("reference", "container", "lanes", "corruption")
CORRUPT_DECODE_S = 60.0  # a corrupt frame's decode must end within this

with open(__file__, "rb") as _f:
    _TEXT = _f.read() * 8


def gen_data(rng: np.random.Generator, n: int | None = None) -> np.ndarray:
    """One input from a family of adversarial-ish distributions (those of
    ``tests/fuzz_diff.py``)."""
    kind = rng.integers(0, 6)
    if n is None:
        n = int(rng.integers(2, 1 << rng.integers(4, 16)) + 2)
    if kind == 0:  # uniform bytes (incompressible)
        return rng.integers(0, 256, n).astype(np.uint8)
    if kind == 1:  # geometric-ish (the reference's bench distribution)
        p = float(rng.uniform(0.05, 0.9))
        return np.minimum(rng.geometric(p, n) - 1, 255).astype(np.uint8)
    if kind == 2:  # sparse alphabet (2..8 symbols, skewed)
        a = int(rng.integers(2, 9))
        syms = rng.choice(256, a, replace=False).astype(np.uint8)
        return rng.choice(syms, n, p=rng.dirichlet(np.full(a, 0.3)))
    if kind == 3:  # long runs
        out, have = [], 0
        while have < n:
            out.append(np.full(int(rng.integers(1, 200)),
                               rng.integers(0, 256), np.uint8))
            have += len(out[-1])
        return np.concatenate(out)[:n]
    if kind == 4:  # one dominant symbol + rare others
        x = np.full(n, rng.integers(0, 256), np.uint8)
        m = rng.random(n) < 0.01
        x[m] = rng.integers(0, 256, int(m.sum()))
        if (x == x[0]).all():  # keep two symbols
            x[-1] ^= 1
        return x
    off = int(rng.integers(0, max(1, len(_TEXT) - n)))  # text-like
    return np.frombuffer(_TEXT[off: off + n], np.uint8).copy()


# --- leg 1: the reference format ---------------------------------------------


def check_reference(data, rng, msg, tally) -> None:
    k = int(rng.choice([1, 2, 3, 5]))
    if len(data) < max(k, 2) + k:  # the codec's minimum input
        return
    try:
        frame = bytearray()
        fse_compress(data, frame, k=k)
    except ValueError:  # degenerate (single-symbol) input
        with pytest.raises(ValueError):
            native.compress(data.tobytes(), k=k)
        tally["reference_degenerate"] += 1
        return
    port = native.compress(data.tobytes(), k=k)
    assert port == bytes(frame), f"port native != spec frame {msg} k={k}"
    out = bytearray()
    assert fse_decompress(port, out, k=k) == len(data), f"spec decode {msg}"
    assert bytes(out) == data.tobytes(), f"spec decode of port frame {msg}"
    back = native.decompress(bytes(frame), k=k, max_out=len(data) + 64)
    assert back == data.tobytes(), f"port decode of spec frame {msg} k={k}"
    tally["reference"] += 1


# --- leg 2: the container ------------------------------------------------------


def container_knobs(rng, wide: bool) -> dict:
    if wide:
        bs = int(rng.choice([256, 1024, 4096, 16384, 65536]))
        lanes = bool(rng.integers(0, 2))
        k = (int(rng.choice([128, 256, 512])) if lanes
             else int(rng.choice([1, 2, 8, 64])))
        k = min(k, bs)  # compress rejects k > block_size
        tl = rng.choice(["auto", "fast", None, 5, 7, 9, 11, 13])
        shared = bool(rng.integers(0, 4) == 0)
    else:
        bs, lanes = 2048, bool(rng.integers(0, 2))
        k = 128 if lanes else int(rng.choice([1, 8]))
        tl = rng.choice(["auto", "fast", None, 9])
        shared = bool(rng.integers(0, 4) == 0)
    tl = None if tl is None else (tl if tl in ("auto", "fast") else int(tl))
    return dict(block_size=bs, k=k, lanes=lanes, table_log=tl,
                bit_pack=lanes and bool(rng.integers(0, 2)),
                checksum=bool(rng.integers(0, 2)), shared_table=shared)


def check_frames(data, kw, rng, msg) -> None:
    """Both packages' frames of ``data`` under ``kw`` are equal, each
    package decodes the frame, and a random range decode agrees."""
    port = PF.compress(data, device="cpu", **kw)
    jax_frame = JF.compress(data, interpret=True, **kw)
    assert port == jax_frame, f"port frame != JAX frame {msg} {kw}"
    assert PF.decompress(jax_frame, device="cpu") == data.tobytes(), \
        f"port decode of the JAX frame {msg} {kw}"
    assert JF.decompress(port, interpret=True) == data.tobytes(), \
        f"JAX decode of the port frame {msg} {kw}"
    if len(data):
        s = int(rng.integers(0, len(data)))
        ln = int(rng.integers(0, len(data) - s + 1))
        want = data[s: s + ln].tobytes()
        assert PF.decompress(port, device="cpu", start=s, length=ln) == want, \
            f"port range decode [{s}, +{ln}) {msg} {kw}"
        assert JF.decompress(port, interpret=True, start=s,
                             length=ln) == want, \
            f"JAX range decode [{s}, +{ln}) {msg} {kw}"


def check_container(data, rng, msg, tally, wide: bool) -> None:
    kw = container_knobs(rng, wide)
    check_frames(data, kw, rng, msg)
    tally["container_lanes" if kw["lanes"] else "container_shared"] += 1
    tally["container_bit_pack"] += kw["bit_pack"]
    tally["container_shared_table"] += kw["shared_table"]


# --- leg 3: the lane entries ---------------------------------------------------


def lane_shape(rng, wide: bool) -> tuple[int, int, int, int]:
    """(B, k, L, R): L >= 10 two times in three, R % 3 == 2 one in two."""
    if wide:
        B = int(rng.integers(1, 4))
        k = int(rng.choice([128, 256, 384, 1024]))
        L = int(rng.integers(10, 16) if rng.random() < 2 / 3
                else rng.integers(5, 10))
        R = int(3 * rng.integers(0, 12) + (2 if rng.random() < 0.5
                                           else rng.integers(0, 2)))
        return B, k, L, max(R, 1)
    B = int(rng.integers(1, 3))
    L = int(rng.choice([10, 11]) if rng.random() < 2 / 3 else 8)
    R = int(rng.choice([8, 17]) if rng.random() < 0.5
            else rng.choice([9, 10]))
    return B, 128, L, R


def lane_blocks(rng, B, k, L, R, edge: str | None) -> np.ndarray:
    """(B, (R+1)*k) uint8 blocks; ``edge`` shapes the lane sizes:
    "equal" gives every lane the same bytes (one size; a constant size
    table, degenerate when its two bytes agree), "small" few rounds of a
    two-symbol alphabet (sizes below 256, a zero high byte), "spread" a
    lane-dependent alphabet (sizes spread wide)."""
    n = (R + 1) * k
    alphabet = min(256, 1 << (L - 1))

    def fold(x):
        return (x.astype(np.int64) % alphabet).astype(np.uint8)

    if edge == "equal":
        col = fold(gen_data(rng, R + 1))
        return np.repeat(col[:, None], k, 1).reshape(1, n).repeat(B, 0)
    if edge == "small":
        return rng.integers(0, 2, (B, n)).astype(np.uint8)
    if edge == "spread":
        width = (np.arange(k) % 8 + 1) * max(1, alphabet // 8)
        return (rng.integers(0, 1 << 16, (B, R + 1, k)) % width).astype(
            np.uint8).reshape(B, n)
    return np.stack([fold(gen_data(rng, n)) for _ in range(B)])


def check_size_tables(sizes: np.ndarray, msg, tally) -> None:
    """Each block's FLAG_PACKED lane-size table packs to the same bytes in
    both packages and unpacks to the sizes in both."""
    for row in sizes:
        st = row.astype("<u2").tobytes()
        packed = PF._pack_size_table(st)
        assert packed == JF._pack_size_table(st), f"size table {msg}"
        for unpack in (PF._unpack_size_table, JF._unpack_size_table):
            got, rest = unpack(packed + b"tail", len(row))
            assert (np.asarray(got) == row).all() and rest == b"tail", \
                f"size table unpack {msg}"
        cs_len = int.from_bytes(packed[:2], "little")
        tally["size_table_raw" if cs_len == 0 else "size_table_fse"] += 1


def check_lanes(rng, msg, tally, wide: bool) -> None:
    B, k, L, R = lane_shape(rng, wide)
    edge = rng.choice([None, None, "equal", "small", "spread"])
    blocks = lane_blocks(rng, B, k, L, R, edge)
    counts = np.stack([np.bincount(b, minlength=256) for b in blocks])
    if ((counts > 0).sum(1) < 2).any():  # single-symbol blocks: RLE
        tally["lanes_single_symbol"] += 1
        return
    nt, logs = normalize_batch(counts, blocks.shape[1], L)
    if not (logs == L).all():  # the alphabet forced a larger table log
        tally["lanes_log_raised"] += 1
        return
    table, tt_bits, tt_fs = native.build_encode_tables(nt, L)
    packs = native.build_decode_tables(nt, L)
    rows = [(table[b], tt_bits[b], tt_fs[b]) for b in range(B)]
    syms = blocks[:, : R * k].reshape(B, R, k)
    init = blocks[:, R * k:]
    W = JPL.encode_w_bound(R, L)
    what = f"{msg} B={B} k={k} L={L} R={R} edge={edge}"
    jw, js = JPL.encode_lanes(syms, init, rows, k=k, L=L, W=W,
                              interpret=True)
    jw, js = np.asarray(jw), np.asarray(js)
    stacked = rng.random() < 0.5
    pw, ps = ops.encode_lanes(syms, init, (table, tt_bits, tt_fs) if stacked
                              else rows, k=k, L=L, W=W, device="cpu")
    pw, ps = to_numpy(pw), ps.numpy()
    assert pw.shape == jw.shape, f"w_act {pw.shape} != {jw.shape} {what}"
    assert (pw == jw).all() and (ps == js).all(), f"encode_lanes {what}"
    jsyms, jfin = JPL.decode_lanes(jw, js, packs, k=k, L=L, R=R,
                                   interpret=True)
    psyms, pfin = ops.decode_lanes(jw, js, packs if stacked else list(packs),
                                   k=k, L=L, R=R, device="cpu")
    assert (psyms.numpy() == np.asarray(jsyms)).all() and \
        (pfin.numpy() == np.asarray(jfin)).all(), f"decode_lanes {what}"
    got = np.concatenate([psyms.numpy().reshape(B, -1), pfin.numpy()], 1)
    assert (got == blocks).all(), f"decode_lanes round trip {what}"
    check_size_tables(ps, what, tally)
    tally["lanes"] += 1
    tally["lanes_L>=10"] += L >= 10
    tally["lanes_R%3==2"] += R % 3 == 2
    if edge is not None:  # the edge blocks as a bit-packed frame
        kw = dict(block_size=(R + 1) * k, k=k, lanes=True, table_log=L,
                  bit_pack=True, checksum=bool(rng.integers(0, 2)))
        check_frames(blocks.reshape(-1), kw, rng, what)
        tally[f"lanes_edge_{edge}"] += 1


# --- leg 4: corruption ---------------------------------------------------------


def check_corruption(data, rng, msg, tally) -> None:
    """Flips in a valid lane frame: the port's decode raises ValueError or
    returns bytes, nothing else, and ends within ``CORRUPT_DECODE_S``."""
    if len(data) < 16:
        tally["corrupt_short_input"] += 1
        return
    kw = dict(block_size=2048, k=128, lanes=True,
              bit_pack=bool(rng.integers(0, 2)),
              checksum=bool(rng.integers(0, 2)))
    comp = bytearray(PF.compress(data, device="cpu", **kw))
    header = rng.random() < 0.5  # the frame + histogram header region
    for _ in range(int(rng.integers(1, 4))):
        pos = int(rng.integers(0, min(160, len(comp)) if header
                               else len(comp)))
        comp[pos] ^= int(rng.integers(1, 256))
    t0 = time.perf_counter()
    try:
        out = PF.decompress(bytes(comp), device="cpu")
        assert isinstance(out, bytes), f"decode returned {type(out)} {msg}"
        tally["corrupt_returned"] += 1
    except ValueError:
        tally["corrupt_raised"] += 1
    except Exception as e:  # noqa: BLE001 - the contract is ValueError only
        raise AssertionError(f"corrupt frame raised {type(e).__name__}: {e} "
                             f"{msg} {kw}") from e
    took = time.perf_counter() - t0
    assert took < CORRUPT_DECODE_S, f"corrupt decode took {took:.1f} s {msg}"


# --- the fuzz loop -------------------------------------------------------------


def run_fuzz(iters: int, seed: int, legs=LEGS, wide: bool = False,
             container_every: int = 4, lanes_every: int = 4,
             max_container_bytes: int = 1 << 13,
             verbose: bool = False) -> Counter:
    """``iters`` iterations from ``seed`` over ``legs``; returns the tally.
    A failure raises AssertionError naming (seed, iteration)."""
    rng = np.random.default_rng(seed)
    tally: Counter = Counter()
    for i in range(iters):
        msg = f"(seed={seed} iter={i})"
        try:
            data = gen_data(rng)
            if "reference" in legs:
                check_reference(data, rng, msg, tally)
            if "container" in legs and i % container_every == 0:
                check_container(data[:max_container_bytes], rng, msg, tally,
                                wide)
            if "lanes" in legs and i % lanes_every == lanes_every // 2:
                check_lanes(rng, msg, tally, wide)
            if "corruption" in legs and i % 2 == 1:
                check_corruption(data[:max_container_bytes], rng, msg, tally)
        except AssertionError:
            raise
        except Exception as e:
            raise AssertionError(f"{type(e).__name__}: {e} {msg}") from e
        tally["iterations"] += 1
        if verbose and i % 50 == 0:
            print(f"iter {i}/{iters} {dict(tally)}", flush=True)
        if i and i % 200 == 0:
            # every new shape is a jit program; the compile caches grow
            # without bound over a long soak (tests/fuzz_diff.py)
            import jax

            jax.clear_caches()
    return tally


@pytest.mark.parametrize("leg", LEGS)
def test_fuzz_quick(leg):
    every = {"container": 2, "lanes": 3}.get(leg, 4)
    tally = run_fuzz(iters=20, seed=0xD1FF, legs=(leg,),
                     container_every=every, lanes_every=every)
    assert tally["iterations"] == 20
    if leg == "lanes":
        assert tally["lanes"] > 0 and tally["size_table_raw"] + \
            tally["size_table_fse"] > 0, tally
    elif leg == "corruption":
        assert tally["corrupt_raised"] + tally["corrupt_returned"] + \
            tally["corrupt_short_input"] == 10, tally
        assert tally["corrupt_raised"] > 0, tally


# the size table's edges on their own: u16 extremes, constant tables (one
# symbol when both bytes agree), tables that compress and that do not
SIZE_TABLES = {
    "zeros": np.zeros(128, np.int64),
    "max": np.full(128, 0xFFFF),
    "one_byte_pattern": np.full(256, 0x0101),
    "two_values": np.tile([0x00FF, 0xFF00], 64),
    "ramp": np.arange(1024) * 64,
    "below_256": np.arange(128) % 256,
    "random": np.random.default_rng(5).integers(0, 1 << 16, 384),
}


@pytest.mark.parametrize("name", SIZE_TABLES)
def test_size_table_edges_match_jax(name):
    tally: Counter = Counter()
    check_size_tables(SIZE_TABLES[name][None], name, tally)
    assert sum(tally.values()) == 1


def test_failure_names_seed_and_iteration(monkeypatch):
    """A fault in the port surfaces as an AssertionError that names the
    (seed, iteration) reproducing it."""
    def broken(*args, **kw):
        raise RuntimeError("injected")

    monkeypatch.setattr(native, "compress", broken)
    with pytest.raises(AssertionError, match=r"seed=3 iter=\d+"):
        run_fuzz(iters=5, seed=3, legs=("reference",))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--seed", type=int,
                    default=np.random.SeedSequence().entropy % (1 << 31))
    ap.add_argument("--wide", action="store_true",
                    help="sample the full configuration space (slow: every "
                         "distinct shape is a JAX compile)")
    ap.add_argument("--legs", default=",".join(LEGS))
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    legs = tuple(args.legs.split(","))
    print(f"fuzzing the port: iters={args.iters} seed={args.seed} "
          f"wide={args.wide} legs={legs}", flush=True)
    t0 = time.perf_counter()
    tally = run_fuzz(args.iters, args.seed, legs=legs, wide=args.wide,
                     verbose=True)
    print(f"OK {time.perf_counter() - t0:.0f} s {dict(tally)}", flush=True)

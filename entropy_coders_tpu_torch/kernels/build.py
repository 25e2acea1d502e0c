"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in ``entropy_coders_tpu_torch/csrc/*.cu`` (and the headers
they share, ``*.cuh``) have a plain C interface (no PyTorch headers), so
they compile in seconds: one nvcc per source, all started together, then
one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <src>.o csrc/<src>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/entropy_coders_tpu_torch/<lib>.so *.o

The build runs at first use, on a machine with the CUDA toolkit, into
``build/entropy_coders_tpu_torch/`` at the repository root, or into a
per-user cache directory when the package is installed (``builddir``). The
library's name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads the library already built. No binary is
committed. ``python -m entropy_coders_tpu_torch.kernels.build`` builds and
prints the compiler's register and shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..builddir import build_dir, writable_build_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c"]
LINK_FLAGS = [*ARCH, "-shared"]

# ctypes signatures of the launchers: every pointer and the stream are
# c_void_p (a plain int would be cut to 32 bits), every size a c_int, every
# 64-bit count a c_longlong.
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # words, sizes, dtab, syms, finals, cursors, B, W, k, L, R, T, RF,
    # stream
    "ect_pl_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P],
    # words, sizes, plane0, plane1, syms, finals, cursors, B, W, k, L, R,
    # layout, T, RF, stream
    "ect_pl_decode_layout": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
    # layout, L, T, RF -> co-resident CTAs per SM on the current device (or
    # -error)
    "ect_pl_decode_layout_occupancy": [_I, _I, _I, _I],
    # blocks, tt_bits, tt_fs, next_state, words, sizes, B, k, L, R, W, T, F,
    # stream
    "ect_pl_encode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P],
    # op, iters, host long long* -> cycles of a dependent chain (latency.cu)
    "ect_latency": [_I, _I, _P],
    # ins[n], outs[n], accs[n], flags[n] (host arrays of device pointers),
    # order[n*n] (bytes), devs[n] (ints), streams[n], n, chunk_vecs,
    # stripe_vecs, m, stride, epoch, variant, peer
    "ect_ring": [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _LL, _I, _I,
                 ctypes.c_ulonglong, _I, _I],
    # dev, variant -> co-resident ring CTAs on device dev (or -error)
    "ect_ring_max_ctas": [_I, _I],
    # dev, peer
    "ect_ring_enable_peer": [_I, _I],
    # words, sizes, out, n_out, meta, B, W, k, pack, stream (repack.cu)
    "ect_lane_merge": [_P, _P, _P, _LL, _P, _I, _I, _I, _I, _P],
    # packed, n_packed, sizes, block_offs, goff, words, B, W, k, pack,
    # stream
    "ect_lane_split": [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # norm, dec, next_state, tt_bits, tt_fs, B, L, half, cluster, threads,
    # stream (tables.cu; the same for the empty launch of that shape)
    "ect_build_tables": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ect_build_tables_empty": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # words, total_bits, packed, syms, emit, finals, done, cursor, err, B,
    # Wd, k, L, size, R, stream (fse_coder.cu, D5)
    "ect_fse_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                       _I, _I, _P],
    # syms, valid, init_syms, finish_slots, table, tt_bits, tt_fs, words,
    # total_bits, err, B, R, k, L, size, W, stream (fse_coder.cu, D4)
    "ect_fse_encode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _LL, _P],
    # the same with the kernel named first (0 D5 one-thread, 1 wide, 2
    # one-warp): the k sweep's entries
    "ect_fse_decode_path": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL,
                            _I, _I, _I, _I, _P],
    "ect_fse_encode_path": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _I, _LL, _P],
    # dir, path, k, L, size, checked, int out[10] -> a launch's kernel,
    # lanes, threads, shared memory, registers, spills, CTAs an SM, ring,
    # sub-round, blocks a CTA (fse_coder.cu)
    "ect_fse_launch_info": [_I, _I, _I, _I, _I, _I, _P],
    # data, n, B, slice, S, grid, threads, out, stream (histogram.cu, D6)
    "ect_histogram": [_P, _LL, _I, _I, _I, _I, _I, _P, _P],
    # dev, threads -> CTAs resident on device dev at once (or -error)
    "ect_histogram_max_ctas": [_I, _I],
    # p1, stride1, n1, p2, stride2, n2, B, seg, U, grid, threads, partial,
    # out, stream (crc32.cu)
    "ect_crc32": [_P, _LL, _LL, _P, _LL, _LL, _I, _I, _I, _I, _I, _P, _P,
                  _P],
    # dev, threads -> CTAs of the crc's chunk kernel resident at once (or
    # -error)
    "ect_crc32_max_ctas": [_I, _I],
}

_lib = None
# what the build in this process cost and what the compiler reported;
# stays (None, "") when the library was already built
last_build = {"seconds": None, "log": ""}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libect_torch_{h.hexdigest()[:16]}.so"


def compile_library(srcs, out: Path) -> str:
    """Compile ``srcs`` (one nvcc a source, all started together) and link
    them into the shared library ``out`` (written atomically); returns the
    compiler's report. Raises with nvcc's output when a step fails."""
    nvcc = _nvcc()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{Path(src).stem}.o") for src in srcs]
    procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(srcs, objs)]
    logs, failed = [], []
    for src, p in zip(srcs, procs):
        _, err = p.communicate()
        logs.append(f"== {Path(src).name}\n{err}")
        if p.returncode != 0:
            failed.append(f"{Path(src).name} ({p.returncode})")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + "\n".join(logs))
        r = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return "\n".join(logs)


def build() -> Path:
    """Compile the sources unless their library exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    writable_build_dir()
    t0 = time.perf_counter()
    log = compile_library(sorted(CSRC.glob("*.cu")), out)
    last_build["seconds"] = time.perf_counter() - t0
    last_build["log"] = log
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


if __name__ == "__main__":
    print(build())
    print(last_build["log"])

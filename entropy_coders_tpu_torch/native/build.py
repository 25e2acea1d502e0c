"""Build the port's C++ host library with g++ and return its path.

    g++ -O3 -std=c++17 -fPIC -fopenmp -shared \\
        -o build/entropy_coders_tpu_torch/libect_torch_host_<hash>.so \\
        entropy_coders_tpu_torch/native/fse_native.cpp

The build runs at first use into ``build/entropy_coders_tpu_torch/`` at the
repository root, or into a per-user cache directory when the package is
installed (``builddir``), beside the CUDA kernels' library. The name carries a hash
of the source and the flags, so an edited source builds anew and an
unchanged one loads the library already built; the name differs from the
JAX package's ``libfse_native.so``, so a process that loads both keeps them
apart. No binary is committed, and nothing falls back: a failed build
raises with the compiler's output. ``python -m
entropy_coders_tpu_torch.native.build`` builds and prints the path.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

from ..builddir import build_dir, writable_build_dir

SRC = Path(__file__).resolve().parent / "fse_native.cpp"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared"]

# what the build in this process cost; stays None when the library was
# already built
last_build = {"seconds": None}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return build_dir() / f"libect_torch_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    writable_build_dir()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        r = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                           capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host library build failed: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host library build failed ({r.returncode}):\n"
                           f"{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    last_build["seconds"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    print(build())

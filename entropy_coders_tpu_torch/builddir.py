"""Where the port's libraries build (the CUDA kernels' and the C++ host
library's): one rule for both build modules.

* In a checkout of the repository (the package's parent directory holds
  the ``pyproject.toml`` that names it), the gitignored
  ``build/entropy_coders_tpu_torch/`` at the repository root.
* Installed (``site-packages/entropy_coders_tpu_torch``: no package owns
  ``site-packages/build/``, and it may be read-only), a per-user cache
  directory: ``$XDG_CACHE_HOME/entropy_coders_tpu_torch/`` or
  ``~/.cache/entropy_coders_tpu_torch/``.

The rule is evaluated at each call, so it follows the environment of the
caller. A directory that cannot be made or written raises with its path.
"""

from __future__ import annotations

import os
from pathlib import Path

PACKAGE = "entropy_coders_tpu_torch"


def is_checkout(root: Path) -> bool:
    """Whether ``root`` is a checkout of the repository: it holds the
    ``pyproject.toml`` that lists this package."""
    try:
        return f'"{PACKAGE}"' in (root / "pyproject.toml").read_text()
    except OSError:
        return False


def build_dir(package_dir: Path | None = None) -> Path:
    """The build directory for the package at ``package_dir`` (default:
    this package). Nothing is created."""
    pkg = Path(__file__).resolve().parent if package_dir is None \
        else Path(package_dir).resolve()
    if is_checkout(pkg.parent):
        return pkg.parent / "build" / PACKAGE
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / PACKAGE


def writable_build_dir(package_dir: Path | None = None) -> Path:
    """``build_dir``, created; raises RuntimeError naming the directory
    when it cannot be made or written."""
    path = build_dir(package_dir)
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"cannot create the build directory {path}: "
                           f"{e}") from e
    if not os.access(path, os.W_OK | os.X_OK):
        raise RuntimeError(f"the build directory {path} is not writable")
    return path

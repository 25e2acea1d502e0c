"""Where the port builds its libraries (entropy_coders_tpu_torch.builddir):
the repository's gitignored ``build/`` in a checkout, a per-user cache
directory when the package is installed. The installed case runs on a fake
install layout: a copy of the package under a temporary ``site-packages``,
imported by a fresh interpreter, which builds the C++ host library there."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from entropy_coders_tpu_torch import builddir  # noqa: E402
from entropy_coders_tpu_torch.kernels import build as KB  # noqa: E402
from entropy_coders_tpu_torch.native import build as NB  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PKG = "entropy_coders_tpu_torch"


def test_checkout_builds_into_the_repo_build_dir():
    want = ROOT / "build" / PKG
    assert builddir.is_checkout(ROOT)
    assert builddir.build_dir() == want
    assert KB.library_path().parent == want
    assert NB.library_path().parent == want
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert "build/" in ignored


def _site_packages(tmp_path) -> Path:
    site = tmp_path / "venv" / "lib" / "site-packages"
    shutil.copytree(ROOT / PKG, site / PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return site


@pytest.mark.parametrize("env", ["xdg", "home"])
def test_installed_layout_uses_the_user_cache(env, tmp_path, monkeypatch):
    site = _site_packages(tmp_path)
    assert not builddir.is_checkout(site)
    if env == "xdg":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        want = tmp_path / "xdg" / PKG
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        want = tmp_path / "home" / ".cache" / PKG
    assert builddir.build_dir(site / PKG) == want
    assert not want.exists()  # asking creates nothing
    assert builddir.writable_build_dir(site / PKG) == want and want.is_dir()


def test_unwritable_build_dir_raises_with_its_path(tmp_path, monkeypatch):
    site = _site_packages(tmp_path)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the cache directory should be")
    monkeypatch.setenv("XDG_CACHE_HOME", str(blocker))
    with pytest.raises(RuntimeError, match=str(blocker / PKG)):
        builddir.writable_build_dir(site / PKG)
    if os.geteuid() != 0:  # root writes through the mode bits
        ro = tmp_path / "ro"
        (ro / PKG).mkdir(parents=True)
        (ro / PKG).chmod(0o555)
        monkeypatch.setenv("XDG_CACHE_HOME", str(ro))
        with pytest.raises(RuntimeError, match=str(ro / PKG)):
            builddir.writable_build_dir(site / PKG)


_PROBE = """
import sys
from pathlib import Path
site, cache = Path(sys.argv[1]), Path(sys.argv[2])
sys.path.insert(0, str(site))
import entropy_coders_tpu_torch as T
from entropy_coders_tpu_torch import native
from entropy_coders_tpu_torch.kernels import build as KB
from entropy_coders_tpu_torch.native import build as NB
assert Path(T.__file__).parent == site / "entropy_coders_tpu_torch", T.__file__
want = cache / "entropy_coders_tpu_torch"
assert KB.library_path().parent == want, KB.library_path()
assert NB.library_path().parent == want, NB.library_path()
lib = NB.build()
assert lib.parent == want and lib.exists(), lib
table, log2 = native.normalize([3, 5] + [0] * 254, 8)
assert int(table.sum()) == 1 << log2
print("BUILT", lib)
"""


def test_installed_copy_builds_its_host_library_in_the_cache(tmp_path):
    """A fresh interpreter imports the copy under ``site-packages`` (not
    the checkout), builds the C++ host library into the cache directory and
    calls it; nothing is written beside the installed package."""
    site = _site_packages(tmp_path)
    cache = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["XDG_CACHE_HOME"] = str(cache)
    r = subprocess.run([sys.executable, "-c", _PROBE, str(site), str(cache)],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BUILT" in r.stdout
    assert list((cache / PKG).glob("libect_torch_host_*.so"))
    assert not (site / "build").exists()
    assert not list((site / PKG).rglob("*.so"))

"""The seeded inputs: the same seed gives the same bytes, another seed other
bytes, and nothing outside ``ect_bench/data`` feeds them."""

import hashlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ect_bench import data

BIG = 2**31 + 12345


@pytest.mark.parametrize("kind", ["text", "gen_sequence"])
def test_same_seed_same_bytes(kind):
    spec = {"kind": kind, "prob": 0.2}
    a = data.make(spec, 300_001, BIG)
    b = data.make(spec, 300_001, BIG)
    assert a.dtype == np.uint8 and len(a) == 300_001
    assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["text", "gen_sequence"])
def test_other_seed_or_stream_other_bytes(kind):
    spec = {"kind": kind, "prob": 0.2}
    a = data.make(spec, 100_000, BIG)
    for other in (data.make(spec, 100_000, BIG + 1),
                  data.make(spec, 100_000, -BIG),
                  data.make(spec, 100_000, BIG, stream=1)):
        assert (a != other).mean() > 0.5


def test_seed_words_take_any_whole_number():
    assert data.seed_words(0) == [0, 0]
    assert data.seed_words(2**40 + 3) == [0, 3, 2**8]
    assert data.seed_words(-5) == [1, 5]


def test_text_longer_draw_extends_shorter_and_threads_do_not_matter():
    long = data.text((1 << 24) + 5000, 7, threads=3)
    short = data.text((1 << 24) - 3, 7, threads=1)
    assert np.array_equal(long[: len(short)], short)


def test_text_is_text_of_the_frozen_vocabulary():
    x = data.text(200_000, 3)
    assert 0 not in np.unique(x)
    s = bytes(x).decode("ascii")
    assert " the " in s and "[[" in s
    c = np.bincount(x, minlength=256)
    p = c[c > 0] / c.sum()
    assert 4.0 < -(p * np.log2(p)).sum() < 5.5  # order-0 bits a byte


def test_bytes_do_not_depend_on_the_checkout(tmp_path):
    """Drawn from a copy of ``ect_bench/data`` alone, in a directory
    without the repository's documents, the bytes are the same."""
    here = data._VOCAB.parent
    pkg = tmp_path / "ect_bench"
    shutil.copytree(here, pkg / "data",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").write_text("")
    code = ("import hashlib, sys; from ect_bench import data; "
            "sys.stdout.write(hashlib.sha256(data.text(250_000, 11).tobytes()"
            ").hexdigest() + hashlib.sha256(data.gen_sequence(0.2, 250_000, 11)"
            ".tobytes()).hexdigest())")
    got = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, check=True).stdout
    want = (hashlib.sha256(data.text(250_000, 11).tobytes()).hexdigest()
            + hashlib.sha256(data.gen_sequence(0.2, 250_000, 11).tobytes())
            .hexdigest())
    assert got == want


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError):
        data.make({"kind": "enwik8"}, 10, 1)

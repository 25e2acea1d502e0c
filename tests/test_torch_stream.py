"""Bounded-memory file streaming of the port (``entropy_coders_tpu_torch.
stream``) against the JAX package's ``stream`` and the port's monolithic
frame, on the CPU, and the port's parser on ``memoryview``s of an ``mmap``
(what ``decompress_file`` and ``checkpoint.Checkpoint`` hand it).

Tolerance: exact. Files are compared byte for byte, decoded bytes equal
the input."""

import json
import mmap
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu import frame as JF  # noqa: E402
from entropy_coders_tpu import stream as JS  # noqa: E402
from entropy_coders_tpu_torch import frame as F  # noqa: E402
from entropy_coders_tpu_torch import stream as S  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402
from tests.data.generate_golden import make_input, make_mixed  # noqa: E402

GOLDEN = Path(__file__).parent / "data" / "golden"
FRAME_CASES = [c for c in json.loads((GOLDEN / "manifest.json").read_text())
               if c["codec"] == "frame"]


@pytest.mark.parametrize("n,chunk", [(10 * 2048 + 321, 3), (4 * 2048, 4),
                                     (2048, 1)])
def test_stream_matches_jax_and_monolithic(tmp_path, n, chunk):
    """The JAX package's ``test_stream_matches_monolithic`` cases: the port's
    file equals the JAX ``compress_file`` output and the port's
    ``frame.compress`` of the whole buffer, and round-trips."""
    data = gen_sequence(0.2, n, seed=n)
    src, dst, jdst, back = (tmp_path / f for f in
                            ("in.bin", "out.fset", "jax.fset", "back.bin"))
    src.write_bytes(data)
    kw = dict(block_size=2048, k=128, chunk_blocks=chunk, checksum=True)
    n_out = S.compress_file(src, dst, device="cpu", **kw)
    JS.compress_file(src, jdst, interpret=True, **kw)
    mono = F.compress(data, block_size=2048, k=128, checksum=True,
                      device="cpu")
    assert dst.read_bytes() == jdst.read_bytes() == mono
    assert n_out == len(mono)
    assert S.decompress_file(dst, back, chunk_blocks=2, device="cpu") == n
    assert back.read_bytes() == data.tobytes()


@pytest.mark.parametrize("bit_pack", [False, True])
def test_stream_lanes_matches_jax(tmp_path, bit_pack):
    """The per-lane path (B1/B2's plain versions) through the file stream,
    three sub-frames and a ragged tail, against the JAX package with its
    Pallas kernels in interpret mode."""
    data = gen_sequence(0.3, 5 * 2048 + 600, seed=7)
    src, dst, jdst, back = (tmp_path / f for f in
                            ("in.bin", "out.fset", "jax.fset", "back.bin"))
    src.write_bytes(data)
    kw = dict(block_size=2048, k=128, chunk_blocks=2, lanes=True,
              table_log=9, bit_pack=bit_pack)
    S.compress_file(src, dst, device="cpu", **kw)
    JS.compress_file(src, jdst, interpret=True, **kw)
    assert dst.read_bytes() == jdst.read_bytes()
    assert F._parse_frame(dst.read_bytes()).packed == bit_pack
    S.decompress_file(dst, back, device="cpu")
    assert back.read_bytes() == data.tobytes()


def test_stream_empty(tmp_path):
    src, dst, back = tmp_path / "e.bin", tmp_path / "e.fset", tmp_path / "e.out"
    src.write_bytes(b"")
    S.compress_file(src, dst, device="cpu")
    assert dst.read_bytes() == F.compress(b"", device="cpu")
    assert S.decompress_file(dst, back, device="cpu") == 0
    assert back.read_bytes() == b""


def test_failed_streaming_leaks_nothing(tmp_path):
    """A failing compress/decompress leaves no temp file and no open
    descriptor behind, and never replaces an existing destination."""
    def live_fds():
        return len(os.listdir("/proc/self/fd"))

    dst = tmp_path / "out.ect"
    dst.write_bytes(b"precious")
    bad = tmp_path / "bad.ect"
    bad.write_bytes(b"XXXXnot a frame")
    base = live_fds()
    for _ in range(5):
        with pytest.raises(FileNotFoundError):
            S.compress_file(tmp_path / "missing", dst, device="cpu")
        with pytest.raises(FileNotFoundError):
            S.decompress_file(tmp_path / "missing", dst, device="cpu")
        with pytest.raises(ValueError):
            S.decompress_file(bad, dst, device="cpu")
    assert live_fds() <= base
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []
    assert dst.read_bytes() == b"precious"


def test_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    """No fallback: a CUDA device without CUDA raises, and the destination
    is left as it was."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = tmp_path / "in.bin", tmp_path / "out.fset"
    src.write_bytes(gen_sequence(0.2, 4096).tobytes())
    with pytest.raises(RuntimeError, match="CUDA"):
        S.compress_file(src, dst, block_size=2048, k=128)
    frame = tmp_path / "f.fset"
    frame.write_bytes(F.compress(gen_sequence(0.2, 4096), block_size=2048,
                                 k=128, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        S.decompress_file(frame, dst)
    assert not dst.exists()
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


@pytest.mark.parametrize("case", FRAME_CASES, ids=[c["name"] for c in FRAME_CASES])
def test_parse_and_decode_mmap_memoryview(tmp_path, case):
    """``_parse_frame``/``_decompress_parsed`` on a ``memoryview`` of an
    ``mmap`` of each golden frame (shared tables, crc tables, bit-packed
    size tables, RAW/RLE blocks): whole and range decodes equal the input
    and the JAX package's decode of the same view."""
    spec = case["input"]
    data = (make_mixed(spec["size"], spec["seed"])
            if spec["kind"] == "mixed_rle_raw" else make_input(spec))
    p = tmp_path / "g.fset"
    p.write_bytes((GOLDEN / case["file"]).read_bytes())
    with open(p, "rb") as f, mmap.mmap(f.fileno(), 0,
                                       access=mmap.ACCESS_READ) as mm:
        mv = memoryview(mm)
        pf = F._parse_frame(mv)
        assert pf.n_blocks == JF._parse_frame(mv).n_blocks
        whole = F._decompress_parsed(pf, device="cpu")
        assert whole == data.tobytes()
        assert whole == JF._decompress_parsed(JF._parse_frame(mv),
                                              interpret=True)
        start, length = 100, len(data) - 300
        assert F._decompress_parsed(pf, start=start, length=length,
                                    device="cpu") == \
            data[start: start + length].tobytes()
        out = bytearray(len(data))
        assert F._decompress_parsed(pf, out=out, device="cpu") == len(data)
        assert bytes(out) == data.tobytes()
        del pf, mv

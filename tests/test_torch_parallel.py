"""The port's block sharding (entropy_coders_tpu_torch.parallel) against the
JAX package's (entropy_coders_tpu.parallel over the 8 virtual CPU devices),
on the CPU: the port's mesh is ``torch.device("cpu")`` eight times (virtual
ranks running the kernels' plain versions).

Tolerance: exact. Frames are compared byte for byte, decoded bytes equal
the input, histograms equal ``np.bincount``. JAX frames are built once per
case by a module-scoped fixture (each costs seconds)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu import frame as JF  # noqa: E402
from entropy_coders_tpu import parallel as JP  # noqa: E402
from entropy_coders_tpu_torch import frame as F  # noqa: E402
from entropy_coders_tpu_torch import parallel as P  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402

CPU = torch.device("cpu")
MESH = (CPU,) * 8


def graft_data():
    """The input of ``__graft_entry__.dryrun_multichip(8)``: 16 blocks of
    2048 bytes."""
    rng = np.random.default_rng(0)
    return (rng.integers(0, 32, 16 * 2048, dtype=np.uint16) ** 2
            % 249).astype(np.uint8)


def fse_two_group_data():
    """12 blocks of 4096 bytes of three skews."""
    return np.concatenate([gen_sequence(p, 4 * (1 << 12), seed=i)
                           for i, p in enumerate((0.05, 0.3, 0.9))])


# name -> (data, knobs): the cases of tests/test_parallel.py, the per-lane
# cases of __graft_entry__.py's multi-chip dry run, then a shared-stream
# frame of two table-log groups
CASES = {
    "roundtrip": (lambda: gen_sequence(0.2, 1 << 16),
                  dict(block_size=1 << 12, k=32)),
    "matches_unsharded": (lambda: gen_sequence(0.3, 1 << 15),
                          dict(block_size=1 << 12, k=16)),
    "uneven_blocks": (lambda: gen_sequence(0.2, 5 * (1 << 12) + 123),
                      dict(block_size=1 << 12, k=16)),
    "shared_table": (lambda: gen_sequence(0.2, 1 << 15),
                     dict(block_size=1 << 12, k=16, shared_table=True)),
    "graft_lanes": (graft_data, dict(block_size=2048, k=128, lanes=True)),
    "graft_bit_pack": (graft_data, dict(block_size=2048, k=128, lanes=True,
                                        bit_pack=True)),
    # the shared-stream path (MODE_FSE) in two table-log groups (L = 9: 10
    # blocks, L = 8: 2), each split over the mesh
    "fse_two_groups": (fse_two_group_data,
                       dict(block_size=1 << 12, k=64, lanes=False,
                            table_log=("fast", 0.0025))),
}


@pytest.fixture(scope="module")
def jax_frames():
    """name -> (data, JAX sharded frame), built once."""
    assert len(jax.devices()) == 8, "tests expect 8 virtual devices"
    mesh = JP.default_mesh()
    out = {}
    for name, (make, kw) in CASES.items():
        data = make()
        extra = dict(interpret=True) if kw.get("lanes") else {}
        out[name] = (data, JP.compress(data, mesh, **kw, **extra))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_frame_matches_jax(name, jax_frames):
    data, jframe = jax_frames[name]
    kw = CASES[name][1]
    frame = P.compress(data, MESH, **kw)
    assert frame == jframe
    # sharding is not a wire knob: the unsharded port frame is the same
    assert frame == F.compress(data, device="cpu", **kw)
    assert P.decompress(jframe, MESH) == data.tobytes()


def test_graft_bit_pack_is_smaller(jax_frames):
    assert len(jax_frames["graft_bit_pack"][1]) < len(
        jax_frames["graft_lanes"][1])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_any_rank_count_same_bytes(n):
    """Uneven and empty shares (5 blocks + a tail over up to 13 ranks),
    on both block paths."""
    data = gen_sequence(0.2, 5 * 2048 + 77, seed=n)
    for kw in (dict(block_size=2048, k=16),
               dict(block_size=2048, k=128, lanes=True, checksum=True)):
        frame = P.compress(data, (CPU,) * n, **kw)
        assert frame == F.compress(data, device="cpu", **kw)
        assert P.decompress(frame, (CPU,) * n) == data.tobytes()


@pytest.mark.parametrize("start,length", [(0, None), (100, 5000),
                                          (4096, 8192), (20000, 480)])
def test_sharded_range_decode(start, length):
    data = gen_sequence(0.2, 5 * 4096 + 123, seed=5)
    frame = P.compress(data, MESH, block_size=4096, k=128, lanes=True)
    end = len(data) if length is None else start + length
    assert P.decompress(frame, MESH, start=start, length=length) == \
        data[start:end].tobytes()
    buf = bytearray(end - start)
    assert P.decompress(frame, MESH, start=start, length=length,
                        out=buf) == end - start
    assert bytes(buf) == data[start:end].tobytes()


def test_sharded_histogram_matches_jax():
    data = gen_sequence(0.2, 1 << 14)
    blocks = data.reshape(8, -1)
    want = np.asarray(JP.sharded_histogram(blocks, JP.default_mesh()))
    got = P.sharded_histogram(blocks, MESH)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.bincount(data,
                                                           minlength=256))


def test_sharded_histogram_uneven():
    data = gen_sequence(0.3, 5 * 1000, seed=9)
    got = P.sharded_histogram(data.reshape(5, -1), MESH)
    np.testing.assert_array_equal(got.numpy(), np.bincount(data,
                                                           minlength=256))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_sharded_histogram_equals_bincount(n):
    """Uneven shares of 4,097-byte rows (unaligned row starts), n CPU
    ranks: the int64 sum equals ``np.bincount`` of all the bytes, and the
    CPU ranks launch no kernel."""
    from entropy_coders_tpu_torch.ops import histogram as H

    rng = np.random.default_rng(n)
    blocks = np.minimum(rng.geometric(0.1, (11, 4097)) - 1, 255).astype(
        np.uint8)
    before = H.HIST_LAUNCHES
    got = P.sharded_histogram(blocks, (CPU,) * n)
    assert got.dtype == torch.int64 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), np.bincount(
        blocks.reshape(-1), minlength=256))
    assert H.HIST_LAUNCHES == before


def test_device_contradicting_mesh_raises():
    data = gen_sequence(0.2, 2 * 4096, seed=7)
    with pytest.raises(ValueError, match="contradicts"):
        P.compress(data, MESH, block_size=4096, k=16, device="cuda")
    frame = P.compress(data, MESH, block_size=4096, k=16, device="cpu")
    with pytest.raises(ValueError, match="contradicts"):
        P.decompress(frame, MESH, device="cuda:0")
    assert P.decompress(frame, MESH, device="cpu") == data.tobytes()


def test_bad_meshes_raise():
    data = gen_sequence(0.2, 4096, seed=8)
    with pytest.raises(ValueError, match="empty mesh"):
        F.compress(data, sharding=P.block_sharding(()))
    with pytest.raises(ValueError, match="empty mesh"):
        P.sharded_histogram(data.reshape(2, -1), ())
    with pytest.raises(ValueError, match="unsupported device"):
        F.compress(data, sharding=P.block_sharding(
            (CPU, torch.device("meta"))))


def test_cuda_mesh_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: a CUDA mesh is valid here")
    data = gen_sequence(0.2, 4096, seed=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.compress(data, (torch.device("cuda", 0),) * 8)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        P.default_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.sharded_histogram(data.reshape(2, -1), (torch.device("cuda"),))


def test_sharded_jax_frames_decode_in_port_shared_table(jax_frames):
    data, jframe = jax_frames["shared_table"]
    pf = F._parse_frame(jframe)
    assert pf.shared
    assert JF.decompress(P.compress(data, MESH, block_size=1 << 12, k=16,
                                    shared_table=True)) == data.tobytes()

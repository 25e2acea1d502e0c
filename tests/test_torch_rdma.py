"""The port's ring collectives (entropy_coders_tpu_torch.parallel.rdma) against
the JAX package's Pallas ring (entropy_coders_tpu.parallel.rdma, TPU
interpret mode on the first n of the 8 virtual CPU devices), on the CPU: a
mesh of ``torch.device("cpu")`` n times runs the kernel's plain version,
which emulates the kernel's slot schedule hop by hop.

Tolerance: exact (integer and float32 chunks are copied bit for bit; the
int32 sums wrap modulo 2^32 in both packages)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu.parallel import rdma as JR  # noqa: E402
from entropy_coders_tpu_torch.parallel import rdma as R  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402

CPU = torch.device("cpu")
NS = [1, 2, 3, 8]


def jax_mesh(n):
    return jax.make_mesh((n,), ("x",), devices=jax.devices()[:n])


def jax_sharded(x, mesh):
    return jax.device_put(jnp.asarray(x), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("x")))


@pytest.mark.parametrize("n", NS)
def test_all_gather_int32_matches_jax(n):
    x = np.random.default_rng(n).integers(0, 1 << 30, (n * 2, 4, 128)).astype(
        np.int32)
    mesh = jax_mesh(n)
    want = np.asarray(JR.ring_all_gather(jax_sharded(x, mesh), mesh,
                                         interpret=True))
    got = R.ring_all_gather(x, (CPU,) * n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("n", NS)
def test_all_gather_float32_matches_jax(n):
    x = np.random.default_rng(n + 10).standard_normal((n, 8, 128)).astype(
        np.float32)
    mesh = jax_mesh(n)
    want = np.asarray(JR.ring_all_gather(jax_sharded(x, mesh), mesh,
                                         interpret=True))
    got = R.ring_all_gather(x, (CPU,) * n).numpy()
    # bit for bit: compare the float32 patterns
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.reshape(got.shape).view(np.int32))


@pytest.mark.parametrize("n", NS)
def test_histogram_reduce_matches_jax(n):
    data = gen_sequence(0.2, n * 4096, seed=n).reshape(n, 4096)
    counts = np.stack([np.bincount(d, minlength=256) for d in data])
    mesh = jax_mesh(n)
    want = np.asarray(JR.ring_all_reduce_histograms(counts, mesh,
                                                    interpret=True))
    got = R.ring_all_reduce_histograms(counts, (CPU,) * n)
    assert got.dtype == torch.int32 and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), counts.sum(axis=0))


def test_histogram_reduce_wraps_like_jax():
    """Counters past 2^31 wrap modulo 2^32 in both packages' int32 sums."""
    n = 3
    counts = np.full((n, 256), (1 << 31) - 5, np.int32)
    counts[:, 7] = np.arange(n, dtype=np.int32) - 9
    mesh = jax_mesh(n)
    want = np.asarray(JR.ring_all_reduce_histograms(counts, mesh,
                                                    interpret=True))
    got = R.ring_all_reduce_histograms(counts, (CPU,) * n).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, counts.sum(axis=0, dtype=np.int32))


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
def test_ring_call_every_rank(n, dtype):
    """Every rank's output is the stacked chunks; with accumulate (int
    types), every rank's accumulator is their sum modulo 2^32."""
    rng = np.random.default_rng(n)
    raw = rng.integers(0, 1 << 32, (n, 3, 128), dtype=np.uint64).astype(
        np.uint32)
    shards = [torch.from_numpy(r.view(np.int32)).view(dtype)
              if dtype != torch.float32
              else torch.from_numpy(r.view(np.float32)) for r in raw]
    acc = dtype != torch.float32
    outs, accs = R._ring_call(shards, (CPU,) * n, accumulate=acc)
    assert len(outs) == n
    for d in range(n):
        assert outs[d].dtype == dtype and outs[d].shape == (n, 3, 128)
        np.testing.assert_array_equal(
            outs[d].view(torch.int32).numpy(), raw.view(np.int32))
    if acc:
        want = raw.astype(np.uint64).sum(axis=0) & 0xFFFFFFFF
        for d in range(n):
            assert accs[d].dtype == dtype
            np.testing.assert_array_equal(
                accs[d].view(torch.int32).numpy(),
                want.astype(np.uint32).view(np.int32))
    else:
        assert accs is None


def test_ring_call_schedule_single_rank():
    x = torch.arange(256, dtype=torch.int32).reshape(2, 128)
    outs, accs = R._ring_call([x], (CPU,), accumulate=True)
    assert torch.equal(outs[0][0], x) and torch.equal(accs[0], x)
    c = np.arange(256, dtype=np.int32)[None]
    np.testing.assert_array_equal(
        R.ring_all_reduce_histograms(c, (CPU,)).numpy(), c[0])


def test_chunk_size_must_be_words():
    with pytest.raises(ValueError, match="multiple of 4"):
        R._ring_call([torch.zeros(6, dtype=torch.uint8)] * 2, (CPU,) * 2)
    with pytest.raises(ValueError, match="does not split"):
        R.ring_all_gather(np.zeros((5, 128), np.int32), (CPU,) * 2)


def test_bad_shards_raise():
    with pytest.raises(ValueError, match="shards for a mesh"):
        R._ring_call([torch.zeros(4, dtype=torch.int32)] * 3, (CPU,) * 2)
    with pytest.raises(ValueError, match="shard 1"):
        R._ring_call([torch.zeros(4, dtype=torch.int32),
                      torch.zeros(8, dtype=torch.int32)], (CPU,) * 2)
    with pytest.raises(ValueError, match="accumulate"):
        R._ring_call([torch.zeros(4, dtype=torch.float32)] * 2, (CPU,) * 2,
                     accumulate=True)
    with pytest.raises(ValueError, match="empty mesh"):
        R.ring_all_gather(np.zeros((2, 128), np.int32), ())


def test_cuda_mesh_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: a CUDA mesh is valid here")
    x = np.zeros((4, 128), np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R.ring_all_gather(x, (torch.device("cuda"),) * 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R._ring_call([torch.zeros(4, dtype=torch.int32)] * 2,
                     (torch.device("cuda", 0),) * 2)
    assert R.RING_LAUNCHES == 0

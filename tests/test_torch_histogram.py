"""The port's per-block byte histogram (``entropy_coders_tpu_torch.ops.histogram``)
against the JAX package's (``entropy_coders_tpu.ops.histogram``), on the CPU.

The same rows, made from a seed with numpy (``tests/histogram_rows.py``:
constant, uniform, geometric and bf16 rows), go through the port's
``histogram_blocks`` and ``histogram_u8`` (the plain version of D6 on CPU
tensors), the JAX package's ``histogram_blocks`` (its CPU scatter), its
``_hist_blocks_eqsum`` (the TPU's form, jitted on the CPU) and
``np.bincount``: B in {1, 3, 9}, n in {1, 15, 16, 17, 4,097, 131,072};
numpy arrays, lists, tensors and a view with a storage offset in;
zero-size inputs. A CUDA-bound call raises without CUDA, a CPU tensor
never launches D6, and a tensor that says it lies on the card reaches the
kernels' library (or its error), never the plain version. D6's launch
picks (``launch_config``) at the main path's shapes on an H100.

Tolerance: exact (counts are integers)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu.ops import histogram as JH  # noqa: E402
from entropy_coders_tpu_torch.kernels import build as KB  # noqa: E402
from entropy_coders_tpu_torch.ops import histogram as H  # noqa: E402
from tests.histogram_rows import KINDS, rows  # noqa: E402

# D6's CTAs of 512 threads resident on an H100 at once: 3 an SM of 132
# (ect_histogram_max_ctas on an NVIDIA H100 80GB HBM3)
H100_CTAS = 132 * 3


def all_kinds(B: int, n: int) -> np.ndarray:
    """(4B, n): B rows of each kind."""
    return np.concatenate([rows(kind, B, n, seed=1000 * i + 10 * B + n)
                           for i, kind in enumerate(KINDS)])


def bincounts(blocks: np.ndarray) -> np.ndarray:
    return np.stack([np.bincount(r, minlength=256) for r in blocks])


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4097, 131072])
@pytest.mark.parametrize("B", [1, 3, 9])
def test_matches_jax_and_bincount(B, n):
    blocks = all_kinds(B, n)
    want = bincounts(blocks)
    np.testing.assert_array_equal(np.asarray(JH.histogram_blocks(blocks)),
                                  want)
    np.testing.assert_array_equal(np.asarray(JH._hist_blocks_eqsum(blocks)),
                                  want)
    got = H.histogram_blocks(blocks, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (4 * B, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(H.histogram_blocks(torch.from_numpy(blocks)), got)
    np.testing.assert_array_equal(
        H.histogram_u8(blocks[-1], device="cpu").numpy(), want[-1])
    np.testing.assert_array_equal(
        np.asarray(JH.histogram_u8(blocks[-1])), want[-1])


@pytest.mark.parametrize("kind", ["numpy", "list", "tensor", "offset_view",
                                  "read_only"])
def test_input_forms(kind):
    """numpy, lists, tensors (a view at a storage offset of 1-15 bytes
    included): the same counts."""
    blocks = rows("geometric", 3, 1000, seed=4)
    want = bincounts(blocks)
    if kind == "offset_view":
        flat = torch.zeros(3 * 1000 + 16, dtype=torch.uint8)
        got = []
        for off in range(1, 16):
            view = flat[off: off + 3 * 1000].view(3, 1000)
            view.copy_(torch.from_numpy(blocks))
            assert view.storage_offset() == off
            got.append(H.histogram_blocks(view))
            assert torch.equal(H.histogram_u8(view[1]), got[-1][1])
        for g in got:
            np.testing.assert_array_equal(g.numpy(), want)
        return
    arg = {"numpy": blocks, "list": blocks.tolist(),
           "tensor": torch.from_numpy(blocks)}.get(kind)
    if kind == "read_only":
        arg = blocks.copy()
        arg.flags.writeable = False
    got = H.histogram_blocks(arg, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        H.histogram_u8(arg[0], device="cpu").numpy(), want[0])


@pytest.mark.parametrize("shape", [(0, 16), (3, 0), (0, 0)])
def test_zero_size(shape):
    blocks = np.zeros(shape, np.uint8)
    got = H.histogram_blocks(blocks, device="cpu")
    assert got.shape == (shape[0], 256) and not got.any()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JH.histogram_blocks(blocks)))
    empty = H.histogram_u8(np.zeros(0, np.uint8), device="cpu")
    assert empty.shape == (256,) and not empty.any()


def test_cpu_tensors_launch_nothing(monkeypatch):
    """CPU tensors run the plain version and never reach the kernels'
    library."""
    def no_library():
        raise AssertionError("the library was loaded for a CPU tensor")

    monkeypatch.setattr(KB, "load", no_library)
    before = H.HIST_LAUNCHES
    blocks = rows("uniform", 3, 4097, seed=5)
    H.histogram_blocks(blocks, device="cpu")
    H.histogram_blocks(torch.from_numpy(blocks))
    H.histogram_u8(torch.from_numpy(blocks[0]))
    H.histogram_call(torch.from_numpy(blocks))
    assert H.HIST_LAUNCHES == before


def test_cuda_bound_calls_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blocks = rows("uniform", 2, 100, seed=6)
    with pytest.raises(RuntimeError, match="CUDA"):
        H.histogram_blocks(blocks)
    with pytest.raises(RuntimeError, match="CUDA"):
        H.histogram_blocks(torch.from_numpy(blocks), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        H.histogram_u8(blocks[0])


class OnCuda(torch.Tensor):
    """A meta tensor that says it lies on the card: the wrapper's device
    rule without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(3, 4097), (0, 16), (2, 0)])
def test_cuda_tensors_launch_or_raise(monkeypatch, shape):
    """On a CUDA tensor the wrapper takes the kernels' library or raises
    its error: the plain version never runs there, zero-size inputs
    included."""
    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    def no_library():
        raise RuntimeError("the kernels' library did not build")

    monkeypatch.setattr(H, "histogram_blocks_ref", no_plain)
    monkeypatch.setattr(KB, "load", no_library)
    t = torch.empty(shape, dtype=torch.uint8, device="meta").as_subclass(
        OnCuda)
    before = H.HIST_LAUNCHES
    with pytest.raises(RuntimeError, match="did not build"):
        H.histogram_call(t)
    assert H.HIST_LAUNCHES == before


@pytest.mark.parametrize("bad", ["one_dim", "int32", "meta"])
def test_bad_tensors_are_refused(bad):
    t = {"one_dim": torch.zeros(16, dtype=torch.uint8),
         "int32": torch.zeros((2, 16), dtype=torch.int32),
         "meta": torch.empty((2, 16), dtype=torch.uint8, device="meta")}[bad]
    with pytest.raises(ValueError):
        H.histogram_call(t)


# (B, n) -> (S, slice, grid) on an H100: the main path's launch shapes
PICKS = {(8, 16 << 20): (49, 342400, 392),     # throughput / parity
         (1024, 128 << 10): (1, 131072, 396),  # default / shared stream
         (1, 16 << 20): (396, 42368, 396),     # a share of 8 virtual ranks
         (128, 128 << 10): (3, 43696, 384),    # the same, default point
         (256, 4 << 20): (3, 1398112, 396),    # config 4 on one card
         (1, 4096): (1, 4096, 1)}              # graft's block


@pytest.mark.parametrize("B,n", list(PICKS))
def test_launch_config_picks(B, n):
    assert H.launch_config(B, n, H100_CTAS) == PICKS[(B, n)]


@pytest.mark.parametrize("ctas", [1, 7, 396])
@pytest.mark.parametrize("B", [1, 2, 9, 300])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4097, 100_000, 16 << 20,
                               (5 << 30) + 3])
def test_launch_config_covers_every_byte(n, B, ctas):
    """Slices of a multiple of 16 bytes, at most 2^30, that cover the block
    with no empty slice; no more CTAs than the card holds or units."""
    S, slice_, grid = H.launch_config(B, n, ctas)
    assert slice_ % 16 == 0 and 16 <= slice_ <= H.MAX_SLICE
    assert (S - 1) * slice_ < n <= S * slice_
    assert 1 <= grid <= min(ctas, B * S)


def test_launch_config_refuses_empty():
    with pytest.raises(ValueError):
        H.launch_config(0, 16, 264)
    with pytest.raises(ValueError):
        H.launch_config(1, 0, 264)

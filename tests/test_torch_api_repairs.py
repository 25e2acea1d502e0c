"""The port's public functions called with the JAX package's own arguments,
against the JAX functions on the same numpy inputs, on the CPU:

* ``utils.checked.checked_encode_core`` / ``checked_decode_core``: one
  (R, k) stream and the JAX argument list (the JAX cores run under
  checkify, as the JAX package's tests run them);
* ``ops.histogram.histogram_blocks(data_blocks)``: numpy arrays, lists and
  tensors; a bad shape or dtype raises ``ValueError``;
* ``parallel.multihost.init_distributed(..., cpu_collectives="gloo")``;
* the jax-free helpers ``constants.mask`` / ``ilog2`` and
  ``ops.device_repack.merge_bits_np``, and the package's ``TABLE_LOG_*``.

Tolerance: exact. Counts and words are compared by value (the port's
counts and words are int64, the JAX package's uint32)."""

import inspect
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import entropy_coders_tpu as J  # noqa: E402
from entropy_coders_tpu import constants as JK  # noqa: E402
from entropy_coders_tpu.ops import device_repack as JDR  # noqa: E402
from entropy_coders_tpu.ops import histogram as JH  # noqa: E402
from entropy_coders_tpu.parallel import multihost as JMH  # noqa: E402
from entropy_coders_tpu.spec.codec import fse_compress  # noqa: E402
from entropy_coders_tpu.spec.fse import DecodeTable, EncodeTable  # noqa: E402
from entropy_coders_tpu.utils import checked as JCK  # noqa: E402
import entropy_coders_tpu_torch as T  # noqa: E402
from entropy_coders_tpu_torch import constants as K  # noqa: E402
from entropy_coders_tpu_torch.ops import device_repack as DR  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.ops.histogram import histogram_blocks  # noqa: E402
from entropy_coders_tpu_torch.parallel import multihost as MH  # noqa: E402
from entropy_coders_tpu_torch.utils import checked as CK  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402


# --- C2: the checked cores ------------------------------------------------------


def jax_core_inputs(src, k):
    """The JAX package's ``encode_interleaved`` core arguments for one
    stream (entropy_coders_tpu/ops/coder.py), as numpy arrays."""
    dst = bytearray()
    hist, _ = fse_compress(src, dst, k=k)
    n = len(src)
    m = n - k
    R = max(-(-m // k), 1)
    syms = np.concatenate([src[:m][::-1], np.zeros(R * k - m, np.uint8)])
    t = EncodeTable(hist)
    enc = (syms.reshape(R, k), (np.arange(R * k) < m).reshape(R, k),
           src[n - k:][::-1].copy(),
           np.array([(n - 1 - s) % k for s in range(k - 1, -1, -1)],
                    np.int32),
           np.asarray(t.tt_bits), np.asarray(t.tt_find_state),
           np.asarray(t.table))
    W = -(-((R * k + k) * 16 + 32) // 32) + 2
    return hist, enc, dict(k=k, L=hist.log2, W=W)


@pytest.mark.parametrize("k", [2, 64])
def test_checked_cores_take_the_jax_arguments(k):
    src = gen_sequence(0.2, 3000, seed=k)
    hist, enc, kw = jax_core_inputs(src, k)
    jwords, jbits = JCK.checked_encode_core(*enc, **kw)
    words, bits = CK.checked_encode_core(*enc, **kw, device="cpu")
    assert words.shape == (kw["W"],) and bits.dim() == 0
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jwords).astype(np.int64))
    assert int(bits) == int(jbits)
    # tensors in: their device, no device= needed
    words_t, bits_t = CK.checked_encode_core(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in enc), **kw)
    assert torch.equal(words_t, words) and torch.equal(bits_t, bits)

    # the decode starts below the marker bit, the encode's last
    dec = (np.concatenate([np.asarray(jwords), np.zeros(2, np.uint32)]),
           int(jbits) - 1, np.asarray(DecodeTable(hist).packed, np.uint32))
    R_dec = -(-len(src) // k) + 1  # decode_interleaved's capacity rule
    want = JCK.checked_decode_core(*dec, k=k, L=hist.log2, R=R_dec)
    got = CK.checked_decode_core(*dec, k=k, L=hist.log2, R=R_dec,
                                 device="cpu")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    syms, emit_count, finals, done, _ = got
    assert bool(done) and int(emit_count) == len(src) - k
    np.testing.assert_array_equal(
        np.concatenate([syms.numpy().reshape(-1)[: int(emit_count)],
                        finals.numpy()]), src)


def test_checked_cores_need_cuda_for_numpy(monkeypatch):
    """numpy inputs without ``device=`` go to ``"cuda"``, as every entry's
    do: without CUDA that raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, enc, kw = jax_core_inputs(gen_sequence(0.2, 1000), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        CK.checked_encode_core(*enc, **kw)


# --- C3: histogram_blocks ---------------------------------------------------------


def _blocks():
    return gen_sequence(0.3, 4 * 1000, seed=3).reshape(4, 1000)


@pytest.mark.parametrize("kind", ["numpy", "read_only", "strided", "list",
                                  "tensor"])
def test_histogram_blocks_takes_any_array(kind):
    blocks = _blocks()
    want = np.asarray(JH.histogram_blocks(data_blocks=blocks))
    arg = {"numpy": blocks, "list": blocks.tolist(),
           "strided": np.asfortranarray(blocks),
           "tensor": torch.from_numpy(blocks)}.get(kind)
    if kind == "read_only":
        arg = blocks.copy()
        arg.flags.writeable = False
    got = histogram_blocks(data_blocks=arg, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (4, 256)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if kind == "tensor":  # the tensor's device, positionally
        assert torch.equal(histogram_blocks(arg), got)


@pytest.mark.parametrize("bad", ["one_dim", "three_dim", "int32_tensor"])
def test_histogram_blocks_bad_input_raises(bad):
    blocks = _blocks()
    arg = {"one_dim": blocks.reshape(-1), "three_dim": blocks[None],
           "int32_tensor": torch.from_numpy(blocks.astype(np.int32))}[bad]
    with pytest.raises(ValueError, match="data_blocks"):
        histogram_blocks(arg, device="cpu")


def test_histogram_blocks_numpy_goes_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        histogram_blocks(_blocks())


# --- C4: init_distributed ---------------------------------------------------------


def test_init_distributed_takes_the_jax_keywords():
    jax_params = inspect.signature(JMH.init_distributed).parameters
    port_params = inspect.signature(MH.init_distributed).parameters
    for name, p in jax_params.items():
        assert name in port_params
        assert port_params[name].default == p.default


def test_init_distributed_cpu_collectives_gloo():
    """The JAX call, in one process (world size 1): gloo is the backend."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    try:
        MH.init_distributed(f"127.0.0.1:{port}", num_processes=1,
                            process_id=0, cpu_collectives="gloo")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert MH.owned_blocks(7) == (0, 7)
        MH.init_distributed(cpu_collectives="gloo")  # already initialised
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("kw", [dict(cpu_collectives="mpi"),
                                dict(cpu_collectives="gloo", backend="nccl")])
def test_init_distributed_bad_cpu_collectives_raise(kw):
    with pytest.raises(ValueError, match="cpu_collectives"):
        MH.init_distributed("127.0.0.1:1", 2, 0, **kw)


# --- the jax-free helpers ---------------------------------------------------------


@pytest.mark.parametrize("bits", [0, 1, 7, 16, 32, 33])
def test_mask_matches_jax(bits):
    assert K.mask(bits) == JK.mask(bits)


@pytest.mark.parametrize("x", [1, 2, 3, 255, 256, 1 << 31, (1 << 40) + 5])
def test_ilog2_matches_jax(x):
    assert K.ilog2(x) == JK.ilog2(x)


@pytest.mark.parametrize("x", [0, -1])
def test_ilog2_non_positive_raises(x):
    with pytest.raises(ValueError):
        JK.ilog2(x)
    with pytest.raises(ValueError, match="non-positive"):
        K.ilog2(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_bits_np_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k, W = 128, 12
    sizes = rng.integers(0, 32 * (W - 2), k).astype(np.int32)
    words = rng.integers(0, 1 << 32, (W, k), dtype=np.uint32)
    got = DR.merge_bits_np(words, sizes)
    assert got == JDR.merge_bits_np(words, sizes)
    assert got == PL.lane_merge_batch(words[None], sizes[None],
                                      pack_bits=True)[0]


def test_package_table_log_constants():
    for name in ("TABLE_LOG_DEFAULT", "TABLE_LOG_MAX", "TABLE_LOG_MIN"):
        assert getattr(T, name) == getattr(J, name)
        assert name in T.__all__

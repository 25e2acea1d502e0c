"""Compressed checkpoints of the port (``entropy_coders_tpu_torch.
checkpoint``) against the JAX package's ``checkpoint`` and the ``ckpt_small``
golden, on the CPU: the ``FSCK`` file is byte-identical, so a checkpoint
written by either package loads in the other.

Tolerance: exact. Files are compared byte for byte (the golden by sha256),
leaves bit for bit (dtype, shape and bytes)."""

import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

from entropy_coders_tpu import checkpoint as JC  # noqa: E402
from entropy_coders_tpu_torch import checkpoint as C  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.tools.bench_data import ckpt_tree  # noqa: E402
from tests.data.generate_golden import make_ckpt_tree  # noqa: E402

GOLDEN = Path(__file__).parent / "data" / "golden"
CKPT = next(c for c in json.loads((GOLDEN / "manifest.json").read_text())
            if c["name"] == "ckpt_small")
CKPT_KW = {kk: CKPT[kk] for kk in ("block_size", "k", "lanes", "checksum")}
KW = dict(block_size=2048, k=128, lanes=True)


def _np(leaf):
    """A leaf as a numpy array (torch bf16/fp8 through ml_dtypes)."""
    if isinstance(leaf, torch.Tensor):
        name = C._NAMES[leaf.dtype]
        dt = np.dtype(getattr(ml_dtypes, name, None) or name)
        raw = leaf.contiguous().reshape(-1).view(torch.uint8).numpy()
        return raw.view(dt).reshape(tuple(leaf.shape))
    return np.asarray(leaf)


def assert_tree_equal(a, b, path="<root>"):
    """Same structure; leaves with the same dtype name, shape and bytes."""
    if a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}/{i}")
    else:
        x, y = _np(a), _np(b)
        assert x.dtype.name == y.dtype.name, path
        assert x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


def test_bf16_leaf_bytes_equal_ml_dtypes():
    """The torch-built bf16 leaf of ``ckpt_tree`` is the golden tree's
    ``ml_dtypes`` leaf, and float64 -> bf16 agrees between torch and
    ``ml_dtypes`` also next to ties (where rounding straight from float64
    and rounding through float32 differ)."""
    ours = ckpt_tree(12)["params"]["emb"]
    theirs = make_ckpt_tree(12)["params"]["emb"]
    assert ours.dtype == torch.bfloat16 and theirs.dtype == ml_dtypes.bfloat16
    assert ours.view(torch.int16).numpy().tobytes() == theirs.tobytes()
    rng = np.random.default_rng(3)
    base = rng.standard_normal(4096).astype(ml_dtypes.bfloat16).astype(
        np.float64)
    half_ulp = np.abs(base) * 2.0 ** -9
    near = base + half_ulp * (1 + rng.choice([-1, 1], base.size) * 2.0 ** -30)
    x = np.concatenate([rng.standard_normal(4096), near])
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    assert got.tobytes() == x.astype(ml_dtypes.bfloat16).tobytes()


def test_ckpt_small_reproduced(tmp_path):
    """The port writes ``ckpt_small.bin`` by sha256 from the torch-built
    tree, and loads the golden file to that tree."""
    p = tmp_path / "g.fsck"
    C.save_pytree(p, ckpt_tree(CKPT["input"]["seed"]), device="cpu",
                  **CKPT_KW)
    assert hashlib.sha256(p.read_bytes()).hexdigest() == CKPT["sha256"]
    got = C.load_pytree(GOLDEN / CKPT["file"], device="cpu")
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert isinstance(got["opt"][1], tuple) and got["opt"][1][1] is None
    assert_tree_equal(got, ckpt_tree(CKPT["input"]["seed"]))
    assert_tree_equal(got, make_ckpt_tree(CKPT["input"]["seed"]))


def _state_dict(seed=0):
    """A small module's state_dict, bf16 and float32, plus a buffer."""
    g = torch.Generator().manual_seed(seed)
    return {"emb.weight": torch.randn(64, 24, generator=g).to(torch.bfloat16),
            "fc.weight": torch.randn(24, 40, generator=g) * 0.02,
            "fc.bias": torch.zeros(40),
            "ln.weight": torch.ones(24, dtype=torch.bfloat16),
            "steps": torch.tensor(7, dtype=torch.int64),
            "mask": torch.rand(5, 5, generator=g) > 0.5}


def test_port_checkpoint_loads_in_jax_and_back(tmp_path):
    """A port-written state_dict equals the JAX file of the same arrays
    byte for byte, and each package loads the other's file."""
    sd = _state_dict()
    p, jp = tmp_path / "port.fsck", tmp_path / "jax.fsck"
    n = C.save_pytree(p, sd, checksum=True, device="cpu", **KW)
    assert n == p.stat().st_size
    JC.save_pytree(jp, {k: _np(v) for k, v in sd.items()}, checksum=True,
                   interpret=True, **KW)
    assert p.read_bytes() == jp.read_bytes()
    assert_tree_equal(JC.load_pytree(p), sd)
    back = C.load_pytree(jp, device="cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in back.values())
    assert_tree_equal(back, sd)
    for name in sd:
        assert torch.equal(back[name], sd[name])


def test_jax_tree_with_fp8_and_odd_leaves_loads(tmp_path):
    """A JAX-written tree with every node type, fp8, a big-endian leaf, a
    0-d scalar and an empty leaf loads in the port with the same bytes."""
    rng = np.random.default_rng(1)
    tree = {"a": [rng.standard_normal((9, 5)).astype(">f4"),
                  (np.asarray(3.5), None)],
            "f8": rng.standard_normal(33).astype(ml_dtypes.float8_e4m3fn),
            "e5": rng.standard_normal(7).astype(ml_dtypes.float8_e5m2),
            "u16": rng.integers(0, 1 << 16, 11).astype(np.uint16),
            "c64": (rng.standard_normal(3) + 1j).astype(np.complex64),
            "empty": np.zeros((0, 4), np.int32)}
    jp, p = tmp_path / "jax.fsck", tmp_path / "port.fsck"
    JC.save_pytree(jp, tree, block_size=2048, k=16, interpret=True)
    got = C.load_pytree(jp, device="cpu")
    want = dict(tree, a=[tree["a"][0].astype("<f4"), tree["a"][1]])
    assert_tree_equal(got, want)
    C.save_pytree(p, tree, block_size=2048, k=16, device="cpu")
    assert p.read_bytes() == jp.read_bytes()


def test_torch_leaves_any_layout(tmp_path):
    """Leaves that need grad, are not contiguous or are views save as
    their values."""
    w = torch.randn(8, 6, requires_grad=True)
    tree = {"t": w.t(), "s": w[::2, 1:], "g": w}
    p = tmp_path / "c.fsck"
    C.save_pytree(p, tree, device="cpu", **KW)
    got = C.load_pytree(p, device="cpu")
    for k, v in tree.items():
        assert torch.equal(got[k], v.detach())


def test_load_leaf_decodes_only_its_blocks(tmp_path, monkeypatch):
    """``load_leaf`` and ``load_pytree(leaves=...)`` decode only the blocks
    under the leaf's byte range (every block is MODE_FSE_PL: small ints)."""
    g = torch.Generator().manual_seed(2)
    sd = {f"layer{i}.weight": torch.randint(0, 9, (64, 32), generator=g,
                                            dtype=torch.int32)
          for i in range(4)}
    p = tmp_path / "c.fsck"
    C.save_pytree(p, sd, device="cpu", **KW)
    decoded = []
    real = PL.decode_call

    def counting(words, *a, **kw):
        decoded.append(words.shape[0])
        return real(words, *a, **kw)

    monkeypatch.setattr(PL, "decode_call", counting)
    with C.Checkpoint(p, device="cpu") as ck:
        m = ck.leaf_meta("layer2.weight")
        got = ck.load_leaf("layer2.weight")
        assert torch.equal(got, sd["layer2.weight"])
        first = m["offset"] // KW["block_size"]
        last = (m["offset"] + m["nbytes"] - 1) // KW["block_size"]
        assert sum(decoded) == last - first + 1 == 4
        assert ck._pf.n_blocks == 16
    decoded.clear()
    got = C.load_pytree(p, leaves=["layer0.weight"], device="cpu")
    assert torch.equal(got["layer0.weight"], sd["layer0.weight"])
    assert sum(decoded) == 4


def test_unsupported_dtypes_raise_value_error(tmp_path):
    with pytest.raises(ValueError, match="cannot be held"):
        C.save_pytree(tmp_path / "a", {"x": np.zeros(3, ml_dtypes.int4)},
                      device="cpu")
    with pytest.raises(TypeError):
        C.save_pytree(tmp_path / "a", {"x": object()}, device="cpu")
    with pytest.raises(TypeError, match="keys must be str"):
        C.save_pytree(tmp_path / "a", {1: np.zeros(3)}, device="cpu")
    # a manifest naming a dtype torch cannot hold, from another writer
    jp = tmp_path / "j.fsck"
    JC.save_pytree(jp, {"x": np.zeros(4, ml_dtypes.int4)}, block_size=2048,
                   k=16, interpret=True)
    with pytest.raises(ValueError, match="cannot be held"):
        C.load_pytree(jp, device="cpu")


def _rewrite_manifest(src, dst, fn):
    raw = src.read_bytes()
    (mlen,) = struct.unpack_from("<I", raw, 8)
    man = fn(json.loads(raw[12: 12 + mlen]))
    m = json.dumps(man, separators=(",", ":")).encode()
    dst.write_bytes(raw[:8] + struct.pack("<I", len(m)) + m + raw[12 + mlen:])


@pytest.mark.parametrize("corrupt", [
    lambda m: {**m, "leaves": [{**m["leaves"][0], "dtype": 5}]},
    lambda m: {**m, "leaves": [{**m["leaves"][0], "shape": [7, 7]}]},
    lambda m: {**m, "leaves": [{**m["leaves"][0], "offset": 1 << 40}]},
    lambda m: {**m, "leaves": [{**m["leaves"][0], "nbytes": "x"}]},
    lambda m: {**m, "skel": {"t": "bogus"}},
])
def test_corrupt_manifest_raises_value_error(tmp_path, corrupt):
    p, bad = tmp_path / "c.fsck", tmp_path / "bad.fsck"
    C.save_pytree(p, {"w": np.arange(40, dtype=np.float32)}, device="cpu",
                  **KW)
    _rewrite_manifest(p, bad, corrupt)
    with pytest.raises(ValueError):
        C.load_pytree(bad, device="cpu")


def test_bad_headers_raise_value_error(tmp_path):
    p = tmp_path / "c.fsck"
    for raw in (b"", b"FSCK", b"NOPE" + bytes(8),
                b"FSCK" + struct.pack("<BBHI", 9, 0, 0, 0),
                b"FSCK" + struct.pack("<BBHI", 1, 0, 0, 100)):
        p.write_bytes(raw)
        with pytest.raises(ValueError):
            C.load_pytree(p, device="cpu")


def test_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "c.fsck"
    with pytest.raises(RuntimeError, match="CUDA"):
        C.save_pytree(p, {"w": np.zeros(4096, np.float32)})
    assert not p.exists()
    C.save_pytree(p, {"w": np.zeros(4096, np.float32)}, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        C.load_pytree(p)

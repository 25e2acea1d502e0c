"""The port's config tool (``entropy_coders_tpu_torch.tools.bench_configs``)
against the root ``bench_configs.py``, loaded by path, on the CPU.

* The corpora, byte for byte, at sizes below one repository-text length,
  off the 256 KiB stripe and across it (bf16: torch's rounding against
  ``ml_dtypes``', also at the 32 MiB the configs use).
* The decode-rate timer's block selection against the JAX helper's own
  (``_device_decode_gbps`` run up to its Pallas call, which is replaced by
  a recorder): the same blocks, lane sizes, lane words, normalized tables
  and decode tables, on a per-block frame, a shared-table frame and a
  frame with two table logs, each with an RLE block. The two logs come
  from the default policy ``("fast", 0.0025)``: under ``"auto"`` every
  64 KiB block of these corpora takes L = 11.
* Configs 3 and 6 at a small size on ``device="cpu"``: every frame they
  make equals the JAX package's ``frame.compress(..., lanes=True,
  interpret=True)`` with the same knobs.
* Configs 1 and 2's coder frames against the JAX package's
  ``fse_compress``.
* The timer raises without CUDA.

Tolerance: exact everywhere (integer codec; the corpora are bytes)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import entropy_coders_tpu as ect  # noqa: E402
from entropy_coders_tpu import frame as F  # noqa: E402
from entropy_coders_tpu import native as jnative  # noqa: E402
from entropy_coders_tpu.ops import pl_coder as JPL  # noqa: E402
from entropy_coders_tpu.spec import fse as jfse  # noqa: E402
import entropy_coders_tpu_torch as T  # noqa: E402
from entropy_coders_tpu_torch import native  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from entropy_coders_tpu_torch.ops.unsigned import as_int64  # noqa: E402
from entropy_coders_tpu_torch.tools import bench_configs as BC  # noqa: E402
from entropy_coders_tpu_torch.tools import bench_data  # noqa: E402
from entropy_coders_tpu_torch.tools import l10_attack  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def root_bc():
    """The root ``bench_configs.py`` (its module body imports no JAX)."""
    spec = importlib.util.spec_from_file_location(
        "root_bench_configs", ROOT / "bench_configs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# below one repo-text length; off the stripe; a third across one stripe
SIZES = [1000, 300_001, 800_003]
BUILDERS = ["ascii_block", "mixed_buffer", "corpus", "bf16_tensor_bytes",
            "json_log_bytes", "mixed_corpus"]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", BUILDERS)
def test_corpus_equals_root(name, n, root_bc):
    got = getattr(BC, name)(n)
    assert len(got) == n and got == getattr(root_bc, name)(n)


def test_bf16_equals_ml_dtypes_at_config_size(root_bc):
    n = BC.CORPUS_BYTES
    assert BC.bf16_tensor_bytes(n) == root_bc.bf16_tensor_bytes(n)


def test_repo_text_root(root_bc, tmp_path, monkeypatch):
    assert BC._repo_text() == root_bc._repo_text()
    assert SIZES[0] < len(BC._repo_text())
    assert BC.checkout_root() == ROOT
    (tmp_path / "b.py").write_bytes(b"B")
    (tmp_path / "a.md").write_bytes(b"A")
    (tmp_path / "c.txt").write_bytes(b"C")
    assert BC._repo_text(tmp_path) == b"AB"
    assert BC.ascii_block(5, tmp_path) == b"ABABA"
    monkeypatch.setattr(BC, "is_checkout", lambda root: False)
    with pytest.raises(RuntimeError, match="not a checkout"):
        BC._repo_text()


def test_corpora_share_one_build(root_bc):
    c = BC.Corpora()
    a = c.get("jsonlog", 5000)
    assert c.get("jsonlog", 5000) is a and not a.flags.writeable
    assert a.tobytes() == root_bc.json_log_bytes(5000)
    assert c.get("geo", 4096).tobytes() == bench_data.gen_sequence(
        0.2, 4096).tobytes()
    assert c.sha256("mixed", 3000) == __import__("hashlib").sha256(
        root_bc.mixed_corpus(3000)).hexdigest()


# --- the timer's block selection ----------------------------------------------------

BS, K = 64 << 10, 256


def _frame_data(kind):
    """(frame, data): four 64 KiB blocks, the third constant (RLE). Under
    the default policy the text blocks take L = 11, the geometric one 10."""
    geo = bench_data.gen_sequence(0.2, 2 * BS, 11)
    text = np.frombuffer(BC.corpus(2 * BS), np.uint8)
    if kind == "two_logs":
        data = np.concatenate([text[:BS], geo[:BS], np.full(BS, 7, np.uint8),
                               text[BS:]])
    else:
        data = np.concatenate([geo[:BS], geo[BS:], np.full(BS, 7, np.uint8),
                               text[:BS]])
    knobs = {"per_block": dict(table_log=10), "shared": dict(
        table_log=9, shared_table=True), "two_logs": {}}[kind]
    frame = T.compress(data, block_size=BS, k=K, lanes=True, device="cpu",
                       **knobs)
    return frame, data


class _Stop(Exception):
    pass


def _jax_selection(root_bc, frame, monkeypatch):
    """What the JAX helper hands its Pallas call: (norms, sizes (B, k),
    words (B, W, k) u32) of the blocks it selected, in order."""
    norms, seen = [], {}
    real_dt = jfse.DecodeTable

    def decode_table(norm):
        norms.append(norm)
        return real_dt(norm)

    def decode_call(aw, asz, atb, *, S, W, L, R):
        seen.update(aw=np.asarray(aw), asz=np.asarray(asz), L=L, R=R)
        raise _Stop

    monkeypatch.setattr(jfse, "DecodeTable", decode_table)
    monkeypatch.setattr(JPL, "_decode_call", decode_call)
    with pytest.raises(_Stop):
        root_bc._device_decode_gbps(frame, BS, K)
    B = len(norms)
    Ff = max(1, min(B, JPL.FUSE_LANES // K))
    assert B % Ff == 0  # the helper dropped no ragged superblock here
    Bf, W = B // Ff, seen["aw"].shape[1]
    words = (seen["aw"].view(np.uint32).reshape(Bf, W, Ff, K)
             .transpose(0, 2, 1, 3).reshape(B, W, K))
    return norms, seen["asz"].reshape(B, K), words, seen["L"], seen["R"]


@pytest.mark.parametrize("kind", ["per_block", "shared", "two_logs"])
def test_selection_equals_jax_helper(kind, root_bc, monkeypatch):
    frame, data = _frame_data(kind)
    pf = F._parse_frame(frame)
    norms, sizes, words, L, R = _jax_selection(root_bc, frame, monkeypatch)
    monkeypatch.undo()
    inp = l10_attack.frame_lanes(frame, data, block_size=BS, k=K,
                                 device="cpu", select=True)
    # the RLE block is left out, and so is a block of another log
    want_ids = {"per_block": [0, 1, 3], "shared": [0, 1, 3],
                "two_logs": [0, 3]}[kind]
    assert inp.ids.tolist() == want_ids and inp.n_blocks == 4
    assert int(pf.modes[2]) == F.MODE_RLE
    if kind == "two_logs":
        logs = {F._read_block_header(pf.section(j))[1] for j in (0, 1, 3)}
        assert len(logs) == 2
    assert (inp.L, inp.R) == (L, R)
    assert len(norms) == len(want_ids)
    assert all(n.log2 == L and (inp.norm_tables[j] == n.table).all()
               for j, n in enumerate(norms))
    assert (inp.sizes.numpy() == sizes).all()
    got = as_int64(inp.words).numpy()
    w = min(got.shape[1], words.shape[1])
    assert (got[:, :w] == words[:, :w]).all()
    assert not got[:, w:].any() and not words[:, w:].any()
    packs = np.stack([jfse.DecodeTable(n).packed for n in norms])
    assert (as_int64(inp.dec).numpy() == packs).all()
    syms, finals, cursors = PL.decode_call(inp.words, inp.sizes, inp.dec,
                                           L=L, R=R)
    want = inp.data.reshape(-1, R + 1, K)
    assert not cursors.any()
    assert (syms.numpy() == want[:, :R]).all()
    assert (finals.numpy() == want[:, R]).all()
    assert (inp.data == data.reshape(4, BS)[want_ids].reshape(-1)).all()


def test_strict_parse_unchanged():
    frame, data = _frame_data("per_block")
    with pytest.raises(ValueError, match="block 2 is mode 2"):
        bench_data.parse_pl_frame(frame, BS, K)
    shared, _ = _frame_data("shared")
    with pytest.raises(ValueError, match="shared-table"):
        bench_data.parse_pl_frame(shared, BS, K)
    with pytest.raises(ValueError, match="no MODE_FSE_PL block"):
        bench_data.pl_blocks(T.compress(np.full(2 * BS, 3, np.uint8),
                                        block_size=BS, k=K, lanes=True,
                                        device="cpu"), BS, K, select=True)


# --- the configs' frames ------------------------------------------------------------


def test_config_frames_equal_jax(monkeypatch):
    """Configs 6 and 3 at a small size: 32 KiB a corpus, the points cut to
    8 KiB blocks (k=256 at L=8; k=128 at L=11 bit-packed) and config 3 to
    16 KiB blocks at k=256 under the default policy."""
    made = []
    real = BC.compress

    def recorder(data, **kw):
        frame = real(data, **kw)
        made.append((np.array(data), kw, frame))
        return frame

    monkeypatch.setattr(BC, "compress", recorder)
    monkeypatch.setattr(BC, "THROUGHPUT", dict(block_size=8192, k=256,
                                               table_log=8))
    monkeypatch.setattr(BC, "PARITY", dict(block_size=8192, k=128,
                                           table_log=11, bit_pack=True))
    monkeypatch.setattr(BC, "CONFIG3", dict(block_size=16384, k=256))
    corpora = BC.Corpora()
    res6 = BC.config6("cpu", corpora, size=32768)
    res3 = BC.config3("cpu", corpora, size=65536)
    assert len(made) == 11
    assert set(res6["corpora"]) == {"geo(bench)", "text", "bf16", "jsonlog",
                                    "mixed"}
    assert "device_decode_GBps" not in res3  # no rate off the card
    for data, kw, frame in made:
        assert kw.pop("lanes") is True and kw.pop("device") == "cpu"
        assert F.compress(data, lanes=True, interpret=True, **kw) == frame
    row = res6["corpora"]["bf16"]
    assert row["ratio_throughput_L8"] == len(made[4][2]) / 32768
    assert row["sha256"] == corpora.sha256("bf16", 32768)


def test_coder_frames_equal_jax():
    data = BC.ascii_block(3000)
    want = bytearray()
    ect.fse_compress(data, want, k=1, hist=ect.Histogram(data).normalize(12))
    frame = BC.coder_frame(data, 1, 12, "cpu")
    assert frame == bytes(want)
    assert BC.coder_unframe(frame, 1, len(data) + 16, "cpu") == data
    sl = BC.mixed_buffer(5000)
    for k in (2, 4):
        want = bytearray()
        ect.fse_compress(sl, want, k=k)
        assert BC.coder_frame(sl, k, device="cpu") == bytes(want) == \
            native.compress(sl, k=k) == jnative.compress(sl, k=k)


def test_config5_names_the_port_pipeline():
    res = BC.config5()
    assert res["config"] == 5 and "test_torch_multihost.py" in res["status"]


def test_timer_raises_without_cuda():
    frame, data = _frame_data("per_block")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BC.device_decode_gbps(frame, BS, K, data=data)
    with pytest.raises(ValueError, match="CUDA device"):
        BC.device_decode_gbps(frame, BS, K, data=data, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BC.main(["bench_configs", "5"])

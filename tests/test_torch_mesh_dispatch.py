"""The order in which a mesh's shares reach the lane kernels, on the CPU:
``frame.compress``/``decompress`` with a sharding queue every share's
chunks before they drain any (the JAX package's one call over the whole
mesh), compress a table-log group at a time, decompress every group at
once. The lane entries are wrapped so that a call logs "dispatch" and its
``collect`` logs "collect"; the mesh is ``torch.device("cpu")`` n times
(virtual ranks, the plain versions), on both repack routes.

Tolerance: exact. Frames equal the unsharded frame and the JAX package's
(Pallas in interpret mode), byte for byte; round trips are exact; a
corrupt block in the last share raises ValueError."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu import frame as JF  # noqa: E402
from entropy_coders_tpu_torch import frame as F  # noqa: E402
from entropy_coders_tpu_torch import parallel as P  # noqa: E402
from entropy_coders_tpu_torch.ops import device_repack as DR  # noqa: E402
from entropy_coders_tpu_torch.ops import pl_coder as PL  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402

BS = 4096
KW = dict(block_size=BS, k=128, lanes=True, checksum=True)
CHUNK_BLOCKS = 2  # blocks a kernel call, so that a share has several chunks


def mixed_data():
    """12 blocks in two table-log groups under the default policy: L = 9
    (10 blocks) and L = 8 (blocks 8 and 10, not contiguous)."""
    return np.concatenate([gen_sequence(p, 4 * BS, seed=i)
                           for i, p in enumerate((0.05, 0.3, 0.9))])


@pytest.fixture(scope="module")
def jax_frame():
    data = mixed_data()
    return data, JF.compress(data, interpret=True, **KW)


def spy(monkeypatch, module, name, log):
    """Wrap ``module.<name>`` (a lazy lane entry) so that a call logs
    ("dispatch", L) and its collect ("collect", L)."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        if not callable(out):  # an eager call
            return out
        log.append(("dispatch", kw["L"]))

        def collect():
            log.append(("collect", kw["L"]))
            return out()

        return collect

    monkeypatch.setattr(module, name, wrapped)


def spy_all(monkeypatch):
    log = []
    spy(monkeypatch, DR, "encode_lanes_merged", log)
    spy(monkeypatch, PL, "encode_lanes_norm", log)
    spy(monkeypatch, PL, "decode_lanes_norm", log)
    monkeypatch.setattr(F, "_CHUNK_RAW", CHUNK_BLOCKS * BS)
    return log


def chunks(n_rows, n):
    """Kernel calls of a group of ``n_rows`` blocks over ``n`` ranks."""
    return sum(-(-(hi - lo) // CHUNK_BLOCKS)
               for _, lo, hi in F._shares(n_rows, (None,) * n))


def dispatched_before_collected(entries):
    kinds = [kind for kind, _ in entries]
    return kinds == sorted(kinds, key=lambda k: k != "dispatch")


@pytest.mark.parametrize("route", ["cpp", "device"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_every_share_dispatched_before_any_drain(monkeypatch, jax_frame, n,
                                                 route):
    data, jframe = jax_frame
    if route == "device":  # D1/D2's plain versions, as on a CUDA device
        monkeypatch.setattr(F, "_DEVICE_REPACK", True)
    unsharded = F.compress(data, device="cpu", **KW)
    log = spy_all(monkeypatch)
    mesh = (torch.device("cpu"),) * n
    frame = P.compress(data, mesh, **KW)
    assert frame == jframe == unsharded

    # compress: one table-log group at a time (L = 8 first), each with
    # every share's chunks dispatched before the first is collected
    want = {8: chunks(2, n), 9: chunks(10, n)}
    groups = [L for i, (_, L) in enumerate(log)
              if i == 0 or log[i - 1][1] != L]
    assert groups == [8, 9]
    for L, count in want.items():
        entries = [e for e in log if e[1] == L]
        assert dispatched_before_collected(entries)
        assert entries.count(("dispatch", L)) == count
        assert entries.count(("collect", L)) == count

    # decompress: every group's shares before any drain
    log.clear()
    assert P.decompress(frame, mesh) == data.tobytes()
    assert dispatched_before_collected(log)
    assert len(log) == 2 * sum(want.values())
    assert {L for _, L in log} == {8, 9}


def _corrupt_last_block(frame, kind):
    """The frame with the last block's lane sizes or lane payload
    changed."""
    pf = F._parse_frame(frame)
    i = pf.n_blocks - 1
    assert pf.modes[i] == F.MODE_FSE_PL
    sec = pf.section(i)
    _, _, rest = F._read_block_header(sec)
    at = int(pf.offs[i]) + len(sec) - len(rest)  # the lane sizes
    bad = bytearray(frame)
    if kind == "sizes":
        bad[at] ^= 0x08  # lane 0's size, by 8 bits
    else:
        bad[at + 2 * pf.k + (len(rest) - 2 * pf.k) // 2] ^= 0x5A
    return bytes(bad)


@pytest.mark.parametrize("kind", ["sizes", "payload"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_corrupt_block_in_last_share_raises(monkeypatch, n, kind):
    data = gen_sequence(0.2, 8 * BS, seed=7)
    mesh = (torch.device("cpu"),) * n
    kw = dict(KW, table_log=9)
    frame = _corrupt_last_block(P.compress(data, mesh, **kw), kind)
    log = spy_all(monkeypatch)
    with pytest.raises(ValueError):
        P.decompress(frame, mesh)
    if kind == "sizes":  # refused by the host checks of the last share,
        # after every share before it was dispatched and before any drain
        last = F._shares(8, mesh)[-1]
        assert log == [("dispatch", 9)] * (chunks(8, n) - chunks(
            last[2] - last[1], 1))
    with pytest.raises(ValueError):
        F.decompress(frame, device="cpu")

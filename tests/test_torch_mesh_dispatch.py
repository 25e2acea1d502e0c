"""The order in which a mesh's shares reach the kernels, on the CPU:
``frame.compress``/``decompress`` with a sharding queue every share's work
before they drain any (the JAX package's one call over the whole mesh),
compress a table-log group at a time, decompress every group at once, the
shared-stream (MODE_FSE) groups and the per-lane ones alike. The lane
entries are wrapped so that a call logs "dispatch" and its ``collect``
logs "collect"; the MODE_FSE dispatches log "fse_dispatch" once they have
queued their share, their drains "fse_drain" as they start. The mesh is
``torch.device("cpu")`` n times (virtual ranks, the plain versions), on
both repack routes.

Tolerance: exact. Frames equal the unsharded frame and the JAX package's
(Pallas in interpret mode on the lane path), byte for byte; round trips
are exact; a corrupt block in the last share raises ValueError, where the
share's checks or its drain find it, and the mesh's next call is exact."""

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


# --- the shared-stream (MODE_FSE) groups --------------------------------------

# lanes=False at k = 64; the lane path's default policy splits mixed_data()
# into the same two table-log groups (L = 9: 10 blocks, L = 8: 2)
FSE_KW = dict(block_size=BS, k=64, lanes=False, checksum=True,
              table_log=("fast", 0.0025))


@pytest.fixture(scope="module")
def jax_fse_frame():
    data = mixed_data()
    return data, JF.compress(data, **FSE_KW)


def spy_fse(monkeypatch, log):
    """Wrap the MODE_FSE dispatches (their third argument is the table log)
    so that each logs ("fse_dispatch", L) once it has queued its share, and
    the drains so that each logs ("fse_drain", L) as it starts."""
    table_log = {}
    for name in ("_encode_dispatch_fse", "_decode_dispatch_fse"):
        def dispatch(*a, _real=getattr(F, name), **kw):
            out = _real(*a, **kw)
            table_log[id(out)] = a[2]
            log.append(("fse_dispatch", a[2]))
            return out

        monkeypatch.setattr(F, name, dispatch)
    for name in ("_encode_drain_fse", "_decode_drain_fse"):
        def drain(d, *a, _real=getattr(F, name), **kw):
            log.append(("fse_drain", table_log[id(d)]))
            return _real(d, *a, **kw)

        monkeypatch.setattr(F, name, drain)
    return log


def shares(n_rows, n):
    """Shares of a group of ``n_rows`` blocks over ``n`` ranks."""
    return len(F._shares(n_rows, (None,) * n))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_fse_shares_dispatched_before_any_drain(monkeypatch, jax_fse_frame,
                                                n):
    data, jframe = jax_fse_frame
    unsharded = F.compress(data, device="cpu", **FSE_KW)
    log = spy_fse(monkeypatch, [])
    mesh = (torch.device("cpu"),) * n
    frame = P.compress(data, mesh, **FSE_KW)
    assert frame == jframe == unsharded

    # compress: one table-log group at a time (L = 8 first), every share
    # of it dispatched before its first drain
    want = {8: shares(2, n), 9: shares(10, n)}
    groups = [L for i, (_, L) in enumerate(log)
              if i == 0 or log[i - 1][1] != L]
    assert groups == [8, 9]
    for L, count in want.items():
        assert [e for e in log if e[1] == L] == (
            [("fse_dispatch", L)] * count + [("fse_drain", L)] * count)

    # decompress: every share of both groups before any drain
    log.clear()
    assert P.decompress(frame, mesh) == data.tobytes()
    count = sum(want.values())
    assert [kind for kind, _ in log] == (["fse_dispatch"] * count
                                         + ["fse_drain"] * count)
    assert {L for _, L in log} == {8, 9}


@pytest.mark.parametrize("n", [2, 3, 8])
def test_mixed_frame_every_share_dispatched_before_any_drain(monkeypatch,
                                                             n):
    """A lane frame whose ragged tail is not lane-divisible: the tail is a
    MODE_FSE block beside the per-lane groups."""
    data = np.concatenate([mixed_data(), gen_sequence(0.3, 1000, seed=3)])
    unsharded = F.compress(data, device="cpu", **KW)
    pf = F._parse_frame(unsharded)
    assert pf.modes[-1] == F.MODE_FSE
    assert (pf.modes[:-1] == F.MODE_FSE_PL).all()
    log = spy_fse(monkeypatch, spy_all(monkeypatch))
    mesh = (torch.device("cpu"),) * n
    assert P.compress(data, mesh, **KW) == unsharded
    # compress: the lane groups in turn, then the tail (one share)
    assert log[-2:] == [("fse_dispatch", log[-1][1]), ("fse_drain",
                                                       log[-1][1])]
    assert ("fse_dispatch", log[-1][1]) not in log[:-2]

    log.clear()
    assert P.decompress(unsharded, mesh) == data.tobytes()
    assert dispatched_before_collected(
        [("dispatch" if kind.endswith("dispatch") else "collect", L)
         for kind, L in log])
    assert log.count(("fse_dispatch", log[0][1])) == 1
    assert log[0][0] == "fse_dispatch"


def _fse_frame_with_bad_last_block(data, mesh, how):
    """A lanes=False frame of one table-log group (L = 9) and the same
    frame with its last block's payload zeroed (no marker bit) or one of
    its bytes flipped."""
    kw = dict(block_size=BS, k=64, lanes=False, table_log=9)
    frame = P.compress(data, mesh, **kw)
    assert frame == F.compress(data, device="cpu", **kw)
    pf = F._parse_frame(frame)
    i = pf.n_blocks - 1
    assert pf.modes[i] == F.MODE_FSE
    sec = pf.section(i)
    _, L, payload = F._read_block_header(sec)
    assert L == 9
    at = int(pf.offs[i]) + len(sec) - len(payload)
    bad = bytearray(frame)
    if how == "no_marker":
        bad[at: at + len(payload)] = bytes(len(payload))
    else:
        bad[at + len(payload) // 2] ^= 0x5A
    return frame, bytes(bad)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_fse_missing_marker_raises_at_the_last_dispatch(monkeypatch, n):
    data = gen_sequence(0.2, 8 * BS, seed=7)
    mesh = (torch.device("cpu"),) * n
    frame, bad = _fse_frame_with_bad_last_block(data, mesh, "no_marker")
    log = spy_fse(monkeypatch, [])
    with pytest.raises(ValueError, match="block 7: missing marker bit"):
        P.decompress(bad, mesh)
    # refused by the last share's checks, after every share before it was
    # dispatched and before any drain
    assert log == [("fse_dispatch", 9)] * (shares(8, n) - 1)
    with pytest.raises(ValueError, match="missing marker bit"):
        F.decompress(bad, device="cpu")
    assert P.decompress(frame, mesh) == data.tobytes()


@pytest.mark.parametrize("n", [2, 3, 8])
def test_fse_flipped_payload_raises_at_a_drain(monkeypatch, n):
    data = gen_sequence(0.2, 8 * BS, seed=7)
    mesh = (torch.device("cpu"),) * n
    frame, bad = _fse_frame_with_bad_last_block(data, mesh, "flip")
    log = spy_fse(monkeypatch, [])
    with pytest.raises(ValueError, match="corrupt frame"):
        P.decompress(bad, mesh)
    # every share dispatched, then the drains in order up to the last
    # share's, which finds the fault
    count = shares(8, n)
    assert log == [("fse_dispatch", 9)] * count + [("fse_drain", 9)] * count
    # the mesh's next call is exact
    log.clear()
    assert P.decompress(frame, mesh) == data.tobytes()
    assert len(log) == 2 * count
    with pytest.raises(ValueError, match="corrupt frame"):
        F.decompress(bad, device="cpu")


def test_fse_layout_uploaded_once_a_device(monkeypatch):
    """The emission layout's masks go to a device once a group, not once a
    share: every share's D4 call on a device reads the same tensors."""
    seen = []
    real = F.encode_core

    def encode_core(syms, valid, init_syms, finish_slots, *a, **kw):
        seen.append((id(valid), id(finish_slots)))
        return real(syms, valid, init_syms, finish_slots, *a, **kw)

    monkeypatch.setattr(F, "encode_core", encode_core)
    data = gen_sequence(0.2, 8 * BS, seed=7)
    mesh = (torch.device("cpu"),) * 3
    kw = dict(block_size=BS, k=64, lanes=False, table_log=9)
    assert P.compress(data, mesh, **kw) == F.compress(data, device="cpu",
                                                      **kw)
    assert len(seen) == 3 + 1 and len(set(seen[:3])) == 1


def test_fse_stages_are_named(monkeypatch):
    """The MODE_FSE path's parts are ``ect.*`` ranges, each entered once a
    share, as the per-lane path's are."""
    import contextlib

    entered = []

    @contextlib.contextmanager
    def stage(name):
        entered.append(name)
        yield

    monkeypatch.setattr(F, "_stage", stage)
    data = gen_sequence(0.2, 8 * BS, seed=7)
    mesh = (torch.device("cpu"),) * 3
    frame = P.compress(data, mesh, block_size=BS, k=64, lanes=False)
    for part in ("syms", "h2d", "dispatch", "assemble"):
        assert entered.count(f"ect.compress.fse_{part}") == 3
    # one collect a share, and one for the bit counts of every share
    assert entered.count("ect.compress.fse_collect") == 3 + 1
    entered.clear()
    assert P.decompress(frame, mesh) == data.tobytes()
    for part in ("checks", "h2d", "dispatch", "collect", "write_back"):
        assert entered.count(f"ect.decompress.fse_{part}") == 3


@pytest.mark.parametrize("n", [2, 3, 8])
def test_histograms_dispatched_before_any_collect(monkeypatch, jax_frame, n):
    """Compress queues every share's histogram (D6 on a CUDA device) and
    the d2h of its counts before it waits for the first: "hist" as each
    share's ``histogram_blocks`` returns, "hist_collect" as its counts are
    read. One histogram a share, each of the share's own rows."""
    data, jframe = jax_frame
    log, shares, hists = [], [], set()
    real_hist, real_later = F.histogram_blocks, F._host_later

    def histogram_blocks(t, *a, **kw):
        out = real_hist(t, *a, **kw)
        shares.append(t.shape[0])
        hists.add(id(out))
        log.append("hist")
        return out

    def host_later(t, *a, **kw):
        get = real_later(t, *a, **kw)
        if id(t) not in hists:
            return get

        def collect():
            log.append("hist_collect")
            return get()
        return collect

    monkeypatch.setattr(F, "histogram_blocks", histogram_blocks)
    monkeypatch.setattr(F, "_host_later", host_later)
    mesh = (torch.device("cpu"),) * n
    assert P.compress(data, mesh, **KW) == jframe
    full = len(data) // BS
    assert shares == [hi - lo for _, lo, hi in F._shares(full, mesh)]
    assert log == ["hist"] * len(shares) + ["hist_collect"] * len(shares)

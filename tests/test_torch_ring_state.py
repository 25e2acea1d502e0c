"""What B3's wrapper (entropy_coders_tpu_torch.parallel.rdma) decides on the
host, on the CPU: the stripe split, the CTAs a rank, the destination order,
the ordered peer pairs, and the per-mesh state (``_MeshState``) driven with
a stand-in for the kernels' library that records every call. After the
first call on a mesh, a call is one launcher call with the next epoch and
the same flag words: no peer-access, occupancy or flag set-up again.

Tolerance: exact (integer plans)."""

import ctypes

import pytest

torch = pytest.importorskip("torch")

from entropy_coders_tpu_torch.parallel import rdma as R  # noqa: E402

CHUNK = 264 * 16384 * 4  # the full-width (264, 16384) u32 lane-word chunk


class FakeLib:
    """The three B3 entry points of the kernels' library, recorded."""

    def __init__(self, cap=1056, refuse=()):
        self.calls = []
        self.cap = cap
        self.refuse = set(refuse)

    def ect_ring_enable_peer(self, dev, peer):
        self.calls.append(("enable_peer", dev, peer))
        return 217 if (dev, peer) in self.refuse else 0

    def ect_ring_max_ctas(self, dev, variant):
        self.calls.append(("max_ctas", dev, variant))
        return self.cap

    def ect_ring(self, ins, outs, accs, flags, order, devs, streams, n,
                 vecs, per, m, stride, epoch, variant, peer):
        self.calls.append(("ring", dict(
            flags=list(flags)[:n], order=list(order)[:n * n],
            devs=list(devs)[:n], streams=list(streams)[:n], n=n, vecs=vecs,
            per=per, m=m, stride=stride, epoch=epoch, variant=variant,
            peer=peer)))
        return 0


@pytest.fixture
def cpu_flags(monkeypatch):
    """Flag words on the CPU, whatever device the mesh names."""
    monkeypatch.setattr(R, "_flag_words", lambda d, count: torch.zeros(
        count, dtype=torch.int64))
    monkeypatch.setattr(R, "_STATES", {})


def cuda_mesh(*idx):
    return tuple(torch.device("cuda", i) for i in idx)


def null_ptrs(n):
    return (ctypes.c_void_p * n)()


@pytest.mark.parametrize("vecs,ctas", [(1, 1), (1, 8), (7, 3), (9, 4),
                                       (10, 4), (1024, 1056),
                                       (1_081_344, 1056), (1_081_344, 132),
                                       (5, 5), (100, 7)])
def test_stripes_tile_the_chunk(vecs, ctas):
    """CTA s takes [s*per, min((s+1)*per, vecs)): the stripes cover the
    chunk once, none is empty, only the last is short, m <= ctas."""
    m, per = R._stripes(vecs, ctas)
    assert 1 <= m <= ctas
    bounds = [(s * per, min((s + 1) * per, vecs)) for s in range(m)]
    assert bounds[0][0] == 0 and bounds[-1][1] == vecs
    assert all(hi > lo for lo, hi in bounds)
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    assert all(hi - lo == per for lo, hi in bounds[:-1])


def test_ctas_per_rank():
    # peer: one rank a launch, a thread no fewer than _UNROLL vectors
    assert R._ctas_per_rank(1056, 1, 1_081_344, True) == 1056
    assert R._ctas_per_rank(1056, 1, 2048, True) == 2
    assert R._ctas_per_rank(1056, 1, 1, True) == 1
    with pytest.raises(RuntimeError, match="co-resident"):
        R._ctas_per_rank(0, 1, 1024, True)
    # virtual: the launch's n ranks share what is resident; a plain launch,
    # so fewer resident CTAs than ranks still gives one CTA a rank
    assert R._ctas_per_rank(1056, 8, 1_081_344, False) == 132
    assert R._ctas_per_rank(7, 8, 1024, False) == 1


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 32])
def test_push_order(n):
    """Row r starts at r and visits every rank once; at every step the n
    ranks store to n distinct cards."""
    order = R._push_order(n)
    assert len(order) == n
    for r, row in enumerate(order):
        assert row[0] == r and sorted(row) == list(range(n))
    for i in range(n):
        assert sorted(row[i] for row in order) == list(range(n))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_peer_pairs(n):
    pairs = R._peer_pairs(n)
    assert len(pairs) == len(set(pairs)) == n * (n - 1)
    assert all(i != j and 0 <= i < n and 0 <= j < n for i, j in pairs)


def test_variant():
    assert R._variant(CHUNK) == R.VECTORS
    assert R._variant(16) == R.VECTORS
    assert R._variant(12) == R.WORDS and R._variant(4) == R.WORDS


def test_peer_state_sets_up_once(cpu_flags):
    """Set-up: peer access for every ordered pair, one occupancy query per
    variant and card, (2, n, stride) zeroed words a card. Then each call
    is one launcher call, the epoch one more, the flags the same words,
    never zeroed again; another chunk size changes m and per only."""
    lib = FakeLib()
    mesh = cuda_mesh(0, 1, 2, 3)
    st = R._mesh_state(lib, mesh)
    enables = [c[1:] for c in lib.calls if c[0] == "enable_peer"]
    assert enables == R._peer_pairs(4)
    queries = sorted(c[1:] for c in lib.calls if c[0] == "max_ctas")
    assert queries == sorted((d, v) for d in range(4)
                             for v in (R.WORDS, R.VECTORS))
    assert st.peer and st.stride == 1056
    assert [tuple(f.shape) for f in st.flags] == [(2 * 4 * 1056,)] * 4
    assert all(int(f.abs().sum()) == 0 for f in st.flags)
    assert R._mesh_state(lib, mesh) is st
    set_up = len(lib.calls)

    for f in st.flags:  # what a kernel left: the state never clears it
        f[::7] = 5
    n = 4
    sizes = [CHUNK, CHUNK, 4 * 1000 + 4, 16 * 3]
    for epoch, chunk in enumerate(sizes, start=1):
        got = st.launch(lib, null_ptrs(n), null_ptrs(n), null_ptrs(n), chunk,
                        [11, 12, 13, 14])
        assert got == n
        call = lib.calls[-1]
        assert call[0] == "ring" and len(lib.calls) == set_up + epoch
        a = call[1]
        variant = R._variant(chunk)
        vecs = chunk // (4 if variant == R.WORDS else 16)
        m, per = R._stripes(vecs, R._ctas_per_rank(1056, 1, vecs, True))
        assert (a["epoch"], a["variant"], a["vecs"], a["m"], a["per"]) == (
            epoch, variant, vecs, m, per)
        assert a["peer"] == 1 and a["stride"] == 1056 and a["m"] <= 1056
        assert a["flags"] == [f.data_ptr() for f in st.flags]
        assert a["devs"] == [0, 1, 2, 3] and a["streams"] == [11, 12, 13, 14]
        assert a["order"] == sum(R._push_order(n), [])
    assert all(int(f[::7].min()) == 5 for f in st.flags)
    assert {c[0] for c in lib.calls[set_up:]} == {"ring"}


def test_virtual_state_has_no_flags(cpu_flags):
    """One device named n times: no peer access, no flag words, one launch
    a call over n ranks' share of the resident CTAs."""
    lib = FakeLib(cap=1056)
    st = R._mesh_state(lib, cuda_mesh(0, 0, 0, 0, 0, 0, 0, 0))
    assert not st.peer and st.flags is None
    assert not any(c[0] == "enable_peer" for c in lib.calls)
    assert sorted(c[1:] for c in lib.calls) == [(0, v) for v in
                                                (R.WORDS, R.VECTORS)]
    assert st.launch(lib, null_ptrs(8), null_ptrs(8), null_ptrs(8), CHUNK,
                     [21]) == 1
    a = lib.calls[-1][1]
    assert a["peer"] == 0 and a["flags"] == [None] * 8
    assert a["m"] == 132 and a["streams"][0] == 21


def test_states_are_per_mesh(cpu_flags):
    lib = FakeLib()
    a = R._mesh_state(lib, cuda_mesh(0, 1))
    b = R._mesh_state(lib, cuda_mesh(1, 0))
    c = R._mesh_state(lib, cuda_mesh(0, 1, 2))
    assert a is not b and a is not c
    assert R._mesh_state(lib, cuda_mesh(0, 1)) is a
    a.launch(lib, null_ptrs(2), null_ptrs(2), null_ptrs(2), 64, [1, 2])
    b.launch(lib, null_ptrs(2), null_ptrs(2), null_ptrs(2), 64, [1, 2])
    assert [c[1]["epoch"] for c in lib.calls if c[0] == "ring"] == [1, 1]


def test_refused_pair_raises_with_its_ranks(cpu_flags):
    lib = FakeLib(refuse={(2, 1)})
    with pytest.raises(RuntimeError, match=r"rank 2 \(cuda:2\) cannot store "
                       r"into rank 1 \(cuda:1\)"):
        R._mesh_state(lib, cuda_mesh(0, 1, 2))
    assert cuda_mesh(0, 1, 2) not in R._STATES


def test_no_resident_cta_raises_before_launch(cpu_flags):
    """Peer ranks raise before launching when no CTA can be resident;
    virtual ranks, which never wait, launch one CTA a rank."""
    lib = FakeLib(cap=0)
    st = R._mesh_state(lib, cuda_mesh(0, 1, 2, 3))
    with pytest.raises(RuntimeError, match="co-resident"):
        st.launch(lib, null_ptrs(4), null_ptrs(4), null_ptrs(4), CHUNK,
                  [0, 1, 2, 3])
    assert not any(c[0] == "ring" for c in lib.calls)
    assert st.epoch == 0
    lib = FakeLib(cap=3)
    st = R._mesh_state(lib, cuda_mesh(0, 0, 0, 0))
    assert st.launch(lib, null_ptrs(4), null_ptrs(4), null_ptrs(4), CHUNK,
                     [0]) == 1
    assert lib.calls[-1][1]["m"] == 1 and st.epoch == 1

"""Ring all-gather and all-reduce over a mesh of devices (B3), PyTorch + CUDA.

Counterpart of ``entropy_coders_tpu/parallel/rdma.py``. A mesh is a tuple
of devices, one per rank; a device may repeat. ``ring_all_gather`` and
``ring_all_reduce_histograms`` have the JAX functions' names and meaning:

* ``ring_all_reduce_histograms``: the shared-table histogram all-reduce
  (256 int32 counters per rank, summed modulo 2^32 as the JAX int32
  accumulate sums them);
* ``ring_all_gather``: ordered gather of equal-size per-rank chunks.

``_ring_call`` runs the collective on one chunk per rank and returns every
rank's output and accumulator. One rank passes its chunk through, as the
JAX functions do. For a mesh on the CPU it runs the plain PyTorch version,
``_ring_call_ref``, which models the JAX kernel's ring hop by hop. For a
CUDA mesh it launches B3 (``csrc/ring.cu``) or raises. B3 computes the same
outputs on another schedule: each rank pushes its own chunk into its slot
of every output in one pass, no hops:

* virtual ranks, one device named n times: one launch, no flags;
* peer ranks, n distinct GPUs of this process: one launch a device, the
  CTAs handshaking through flag words on the cards.

The first CUDA call on a mesh sets up its ``_MeshState`` (kept in
``_STATES``): peer access for every ordered pair of its cards, the CTAs a
rank per kernel variant, the destination order, each card's flag words
(zeroed once, never again) and the epoch counter. A later call allocates
its outputs and makes one launcher call; it issues no memset, event,
peer-access or occupancy call.

``RING_LAUNCHES`` counts kernel launches, so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..mesh import devices as mesh_devices
from ..ops.pl_coder import _launch
from ..ops.unsigned import as_int64, signed_view

__all__ = ["RING_LAUNCHES", "ring_all_gather", "ring_all_reduce_histograms"]

RING_LAUNCHES = 0  # B3 launches since import (or since a caller reset it)

_MAX_RANKS = 32  # kMaxRanks of csrc/ring.cu
_THREADS = 256   # kThreads of csrc/ring.cu
_UNROLL = 4      # kUnroll of csrc/ring.cu: vectors a thread loads at once
# csrc/ring.cu's kernel variants: 4-byte words, 16-byte vectors
WORDS, VECTORS = 0, 1
_STATES: dict = {}  # mesh -> _MeshState
_PEER_UNSUPPORTED = 217  # cudaErrorPeerAccessUnsupported


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _variant(chunk_bytes: int) -> int:
    """The kernel variant for a chunk: vectors when it is a multiple of 16
    bytes, else words."""
    return WORDS if chunk_bytes % 16 else VECTORS


def _stripes(vecs: int, ctas: int) -> tuple[int, int]:
    """Split a chunk of ``vecs`` vectors over at most ``ctas`` CTAs a rank:
    (m, per). CTA s takes vectors [s*per, min((s+1)*per, vecs)); every
    stripe is non-empty and only the last may be short."""
    per = _cdiv(vecs, max(1, min(ctas, vecs)))
    return _cdiv(vecs, per), per


def _ctas_per_rank(cap: int, ranks_per_launch: int, vecs: int,
                   peer: bool) -> int:
    """CTAs a rank: as many as can be resident beside the launch's other
    ranks (at least one), but no more than give each thread ``_UNROLL``
    vectors. Peer CTAs wait on CTAs of other cards, so every one must be
    resident: on peer ranks this raises when no CTA fits. Virtual ranks
    never wait and take a plain launch of any size."""
    if peer and cap < 1:
        raise RuntimeError("B3's peer CTAs must be co-resident, but no CTA "
                           "fits on a card")
    return max(1, min(cap // ranks_per_launch,
                      _cdiv(vecs, _THREADS * _UNROLL)))


def _push_order(n: int) -> list[list[int]]:
    """Rank r's destinations in order: (r + i) % n at step i. Row r starts
    at r (the own slot) and, at every step, the n ranks store to n distinct
    cards, so every link carries one stream at once."""
    return [[(r + i) % n for i in range(n)] for r in range(n)]


def _peer_pairs(n: int) -> list[tuple[int, int]]:
    """Every ordered pair (i, j), i != j, of n ranks: rank i stores into
    rank j's output and flags."""
    return [(i, j) for i in range(n) for j in range(n) if i != j]


def _flag_words(device: torch.device, count: int) -> torch.Tensor:
    """``count`` zeroed 64-bit flag words on ``device``, the zeroing done
    when this returns: a peer's first kernel may raise a word before this
    card's stream would have reached a queued memset."""
    words = torch.zeros(count, dtype=torch.int64, device=device)
    torch.cuda.synchronize(device)
    return words


class _MeshState:
    """B3's per-mesh set-up, made at the first CUDA call on ``mesh``:

    * peer ranks: peer access for every ordered pair of the mesh's cards
      (raises with the pair's ranks and devices where the card refuses);
    * the CTAs that can be resident on each card, per kernel variant (the
      least over the cards);
    * the destination order (``_push_order``);
    * peer ranks: each card's (2, n, stride) flag words, zeroed here and
      never again; stride is the most CTAs a rank can have, so every
      (kind, source rank, stripe) has a word of its own whatever a call's m;
    * the epoch, one more each call: the kernel raises flags to it and
      waits until they hold at least it.

    ``launch`` is then a call's only work besides its outputs."""

    def __init__(self, lib, mesh):
        n = len(mesh)
        self.mesh = mesh
        self.peer = len(set(mesh)) == n
        if self.peer:
            for i, j in _peer_pairs(n):
                rc = lib.ect_ring_enable_peer(mesh[i].index, mesh[j].index)
                if rc:
                    why = ("the cards cannot reach each other"
                           if rc == _PEER_UNSUPPORTED else f"CUDA error {rc}")
                    raise RuntimeError(
                        f"B3: rank {i} ({mesh[i]}) cannot store into rank "
                        f"{j} ({mesh[j]}): {why}")
        self.cap = {}
        for variant in (WORDS, VECTORS):
            caps = [lib.ect_ring_max_ctas(d.index, variant)
                    for d in dict.fromkeys(mesh)]
            if min(caps) < 0:
                raise RuntimeError(f"ect_ring_max_ctas failed: CUDA error "
                                   f"{-min(caps)}")
            self.cap[variant] = min(caps)
        self.stride = max(1, max(self.cap.values()))
        order = _push_order(n)
        self.order = (ctypes.c_byte * (n * n))(*sum(order, []))
        self.devs = (ctypes.c_int * n)(*[d.index for d in mesh])
        self.flags = ([_flag_words(d, 2 * n * self.stride) for d in mesh]
                      if self.peer else None)
        self.flag_ptrs = (ctypes.c_void_p * n)(
            *([f.data_ptr() for f in self.flags] if self.peer else [None] * n))
        self.epoch = 0
        self.streams = None  # the streams of the last call

    def launch(self, lib, ins, outs, accs, chunk_bytes: int,
               streams) -> int:
        """One call: ``ins``/``outs``/``accs`` ctypes arrays of n device
        pointers, ``streams`` the stream handles to launch on (each rank's,
        or the one device's on virtual ranks). Returns the kernels
        launched."""
        n = len(self.mesh)
        variant = _variant(chunk_bytes)
        vecs = chunk_bytes // (4 if variant == WORDS else 16)
        m, per = _stripes(vecs, _ctas_per_rank(
            self.cap[variant], 1 if self.peer else n, vecs, self.peer))
        self.epoch += 1
        _launch(lib.ect_ring, ins, outs, accs, self.flag_ptrs, self.order,
                self.devs, (ctypes.c_void_p * n)(*streams), n, vecs, per, m,
                self.stride, self.epoch, variant, int(self.peer))
        return n if self.peer else 1


def _mesh_state(lib, mesh) -> _MeshState:
    """The mesh's state, set up at its first call."""
    state = _STATES.get(mesh)
    if state is None:
        state = _STATES[mesh] = _MeshState(lib, mesh)
    return state


def _check_shards(shards, mesh) -> int:
    """Validate one chunk per rank (same shape and dtype, shard i on
    mesh[i]); return the chunk's size in bytes."""
    if len(shards) != len(mesh):
        raise ValueError(f"{len(shards)} shards for a mesh of {len(mesh)}")
    first = shards[0]
    for i, (t, d) in enumerate(zip(shards, mesh)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"shard {i} must be a torch.Tensor, got {type(t)}")
        if t.shape != first.shape or t.dtype != first.dtype:
            raise ValueError(f"shard {i} is {t.dtype}{tuple(t.shape)}, want "
                             f"{first.dtype}{tuple(first.shape)}")
        if t.device != d:
            raise ValueError(f"shard {i} is on {t.device}, want {d}")
    nbytes = first.numel() * first.element_size()
    if nbytes % 4:
        raise ValueError(f"a chunk of {nbytes} bytes is not a multiple of 4 "
                         "bytes")
    return nbytes


def _wrap_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement)."""
    return (((t + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _ring_call_ref(shards, mesh, accumulate=False):
    """Plain PyTorch version of B3 (same inputs and outputs as
    ``_ring_call``): the JAX kernel's ring schedule hop by hop (at hop s
    rank d forwards slot (d - s) mod n to rank d+1), one torch copy per rank
    and hop, the accumulate in int64 reduced modulo 2^32. B3's schedule
    differs (one pass, each rank pushing its chunk to every peer); its
    results do not."""
    n = len(mesh)
    dtype = shards[0].dtype
    src = [signed_view(t) for t in shards]
    outs = [torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=d)
            for t, d in zip(src, mesh)]
    for d in range(n):
        outs[d][d] = src[d]
    accs = [t.to(torch.int64) for t in src] if accumulate else None
    for s in range(n - 1):
        for d in range(n):
            slot = (d - s) % n
            outs[(d + 1) % n][slot] = outs[d][slot].to(mesh[(d + 1) % n])
        if accumulate:
            for d in range(n):
                accs[d] += outs[d][(d - s - 1) % n].to(torch.int64)
    outs = [o.view(dtype) for o in outs]
    if accumulate:
        accs = [_wrap_i32(a).view(dtype) for a in accs]
    return outs, accs


def _ring_call(shards, mesh, accumulate=False):
    """Run the ring on one chunk per rank (B3's wrapper).

    shards: n tensors of one shape and dtype, shard i on mesh[i]; a chunk's
      size in bytes must be a multiple of 4.
    accumulate: also sum the chunks (int32 or uint32 only, modulo 2^32).
    Returns (outs, accs): outs[i] is rank i's (n,)+chunk output on mesh[i],
    equal to the stacked shards; accs[i] its sum of all chunks (None
    without ``accumulate``).

    One rank has no hop: its chunk is returned as it is. Otherwise a CPU
    mesh runs ``_ring_call_ref``, and a CUDA mesh launches B3 or raises: a
    mesh that names one device n times runs virtual ranks, one of n
    distinct devices runs peer ranks; any other mesh raises."""
    global RING_LAUNCHES
    mesh = mesh_devices(mesh)
    n = len(mesh)
    chunk_bytes = _check_shards(shards, mesh)
    dtype = shards[0].dtype
    if accumulate and dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"accumulate sums int32 or uint32 words, not {dtype}")
    if n == 1:  # no hop: the own chunk is slot 0 and the whole sum
        own = shards[0].clone()
        return [own.unsqueeze(0)], ([own.clone()] if accumulate else None)
    if mesh[0].type == "cpu":
        return _ring_call_ref(shards, mesh, accumulate)
    from ..kernels.build import load

    if n > _MAX_RANKS:
        raise ValueError(f"B3 takes at most {_MAX_RANKS} ranks, got {n}")
    if len(set(mesh)) not in (1, n):
        raise ValueError(f"a CUDA mesh names one device {n} times or {n} "
                         f"distinct devices, got {mesh}")
    lib = load()
    state = _mesh_state(lib, mesh)
    # 16-byte aligned bases (torch's own allocations are)
    src = [signed_view(t).contiguous() for t in shards]
    src = [t if t.data_ptr() % 16 == 0 else t.clone() for t in src]
    shape = tuple(src[0].shape)
    outs = [torch.empty((n,) + shape, dtype=src[0].dtype, device=d)
            for d in mesh]
    accs = ([torch.empty(shape, dtype=torch.int32, device=d) for d in mesh]
            if accumulate else None)
    # each rank's kernels run on one stream, in call order: the epochs rely
    # on it, so a stream other than the last call's first waits for that one
    streams = [torch.cuda.current_stream(d)
               for d in (mesh if state.peer else mesh[:1])]
    if state.streams is not None and streams != state.streams:
        for new, old in zip(streams, state.streams):
            if new != old:
                new.wait_stream(old)
    state.streams = streams
    ptrs = ctypes.c_void_p * n
    RING_LAUNCHES += state.launch(
        lib, ptrs(*[t.data_ptr() for t in src]),
        ptrs(*[t.data_ptr() for t in outs]),
        ptrs(*([t.data_ptr() for t in accs] if accumulate else [None] * n)),
        chunk_bytes, [s.cuda_stream for s in streams])
    if dtype != src[0].dtype:
        outs = [o.view(dtype) for o in outs]
    if accumulate and dtype != torch.int32:
        accs = [a.view(dtype) for a in accs]
    return outs, accs


def ring_all_gather(x, mesh):
    """All-gather ``x`` split on dim 0 into ``len(mesh)`` equal shards,
    shard i on ``mesh[i]``, through the ring. Returns the gathered
    ``(n * lead, ...)`` tensor on ``mesh[0]``: equal to ``torch.cat`` of
    the shards (the JAX function's ``lax.all_gather(..., tiled=True)``)."""
    mesh = mesh_devices(mesh)
    n = len(mesh)
    x = torch.as_tensor(x)
    if n == 1:
        return x.to(mesh[0])
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"leading dim of {tuple(x.shape)} does not split "
                         f"into {n} shards")
    xs = signed_view(x)
    shards = [s.to(d).contiguous() for s, d in zip(xs.tensor_split(n), mesh)]
    outs, _ = _ring_call(shards, mesh)
    return outs[0].reshape((-1,) + tuple(x.shape[1:])).view(x.dtype)


def ring_all_reduce_histograms(counts, mesh):
    """Sum per-rank histogram counters, ``(n, 256)`` with row i going to
    ``mesh[i]``, through the ring's accumulate. Returns the ``(256,)`` int32
    total on ``mesh[0]``, wrapped modulo 2^32 as the JAX int32 sum is
    (exact below 2^31 per counter)."""
    mesh = mesh_devices(mesh)
    n = len(mesh)
    if not isinstance(counts, torch.Tensor):
        counts = torch.from_numpy(np.ascontiguousarray(counts))
    if tuple(counts.shape) != (n, 256):
        raise ValueError(f"counts must be ({n}, 256), got "
                         f"{tuple(counts.shape)}")
    counts = _wrap_i32(as_int64(counts))
    if n == 1:
        return counts.reshape(256).to(mesh[0])
    shards = [counts[i].reshape(2, 128).to(d).contiguous()
              for i, d in enumerate(mesh)]
    _, accs = _ring_call(shards, mesh, accumulate=True)
    return accs[0].reshape(256)

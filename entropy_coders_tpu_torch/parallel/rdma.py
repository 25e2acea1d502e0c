"""Ring all-gather and all-reduce over a mesh of devices (B3), PyTorch + CUDA.

Counterpart of ``entropy_coders_tpu/parallel/rdma.py``. A mesh is a tuple
of devices, one per rank; a device may repeat. ``ring_all_gather`` and
``ring_all_reduce_histograms`` have the JAX functions' names and meaning:

* ``ring_all_reduce_histograms``: the shared-table histogram all-reduce
  (256 int32 counters per rank, summed modulo 2^32 as the JAX int32
  accumulate sums them);
* ``ring_all_gather``: ordered gather of equal-size per-rank chunks.

Ring schedule (unidirectional, n-1 hops), as in the JAX kernel: each rank
first puts its own chunk into its slot of its (n,)+chunk output; at hop
``s`` rank ``d`` forwards slot ``(d - s) mod n`` to rank ``d+1``, which
stores it at the same slot, so every slot travels the ring in order.

``_ring_call`` runs it on one chunk per rank and returns every rank's
output and accumulator. One rank passes its chunk through, as the JAX
functions do. For a mesh on the CPU it runs the plain PyTorch
version, ``_ring_call_ref``: the same slot schedule hop by hop with torch
copies. For a CUDA mesh it launches B3 (``csrc/ring.cu``) or raises:

* virtual ranks, one device named n times: one cooperative launch;
* peer ranks, n distinct GPUs of this process: one launch per device after
  enabling peer access, each stream waiting until every rank's flags are
  zeroed.

``RING_LAUNCHES`` counts kernel launches, so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..frame import _mesh_devices
from ..ops.pl_coder import _launch
from ..ops.unsigned import as_int64, signed_view

__all__ = ["RING_LAUNCHES", "ring_all_gather", "ring_all_reduce_histograms"]

RING_LAUNCHES = 0  # B3 launches since import (or since a caller reset it)

_MAX_RANKS = 32  # kMaxRanks of csrc/ring.cu
_THREADS = 256   # kThreads of csrc/ring.cu


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    ``_ring_call``): the kernel's slot schedule hop by hop, one torch copy
    per rank and hop, the accumulate in int64 reduced modulo 2^32."""
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
    mesh = _mesh_devices(mesh)
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
    if n > _MAX_RANKS:
        raise ValueError(f"B3 takes at most {_MAX_RANKS} ranks, got {n}")
    distinct = len(set(mesh))
    if distinct not in (1, n):
        raise ValueError(f"a CUDA mesh names one device {n} times or {n} "
                         f"distinct devices, got {mesh}")
    peer = distinct == n
    from ..kernels.build import load

    lib = load()
    vec16 = int(chunk_bytes % 16 == 0)
    # 16-byte aligned bases (torch's own allocations are)
    src = [signed_view(t).contiguous() for t in shards]
    src = [t if t.data_ptr() % 16 == 0 else t.clone() for t in src]

    # every CTA of the ring must be resident at once: size the CTAs per rank
    # from what fits, and raise before launching if one per rank does not
    ranks_per_launch = 1 if peer else n
    cap = None
    for d in dict.fromkeys(mesh):
        with torch.cuda.device(d):
            c = lib.ect_ring_max_ctas(vec16)
        if c < 0:
            raise RuntimeError(f"ect_ring_max_ctas failed: CUDA error {-c}")
        cap = c if cap is None else min(cap, c)
    if cap < ranks_per_launch:
        raise RuntimeError(f"B3 needs {ranks_per_launch} co-resident CTAs "
                           f"but only {cap} fit on {mesh[0]}")
    vecs = chunk_bytes // (16 if vec16 else 4)
    m = max(1, min(cap // ranks_per_launch, _cdiv(vecs, _THREADS)))

    shape = tuple(src[0].shape)
    outs = [torch.empty((n,) + shape, dtype=src[0].dtype, device=d)
            for d in mesh]
    accs = ([torch.empty(shape, dtype=torch.int32, device=d) for d in mesh]
            if accumulate else None)
    if peer:
        for r, d in enumerate(mesh):
            _launch(lib.ect_ring_enable_peer, d.index, mesh[(r + 1) % n].index)
        # fresh zeroed flags on each device's own stream; every launching
        # stream waits until all of them (and all earlier work that used the
        # recycled memory) are done, so no flag write lands before a memset
        flags, zeroed = [], []
        for d in mesh:
            with torch.cuda.device(d):
                flags.append(torch.zeros((n - 1) * m, dtype=torch.int32,
                                         device=d))
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                zeroed.append(ev)
        for d in mesh:
            for ev in zeroed:
                torch.cuda.current_stream(d).wait_event(ev)
    else:
        flags = list(torch.zeros((n, (n - 1) * m), dtype=torch.int32,
                                 device=mesh[0]))

    ptrs = ctypes.c_void_p * n
    args = (ptrs(*[t.data_ptr() for t in src]),
            ptrs(*[t.data_ptr() for t in outs]),
            ptrs(*([t.data_ptr() for t in accs] if accumulate else [None] * n)),
            ptrs(*[t.data_ptr() for t in flags]),
            n, chunk_bytes, m)
    launches = ([(r, 1, d) for r, d in enumerate(mesh)] if peer
                else [(0, n, mesh[0])])
    for rank_lo, n_launch, d in launches:
        with torch.cuda.device(d):
            _launch(lib.ect_ring, *args, rank_lo, n_launch, vec16, int(peer),
                    torch.cuda.current_stream(d).cuda_stream)
        RING_LAUNCHES += 1
    outs = [o.view(dtype) for o in outs]
    if accumulate:
        accs = [a.view(dtype) for a in accs]
    return outs, accs


def ring_all_gather(x, mesh):
    """All-gather ``x`` split on dim 0 into ``len(mesh)`` equal shards,
    shard i on ``mesh[i]``, through the ring. Returns the gathered
    ``(n * lead, ...)`` tensor on ``mesh[0]``: equal to ``torch.cat`` of
    the shards (the JAX function's ``lax.all_gather(..., tiled=True)``)."""
    mesh = _mesh_devices(mesh)
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
    mesh = _mesh_devices(mesh)
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

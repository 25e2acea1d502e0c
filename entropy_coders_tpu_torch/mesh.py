"""The devices a frame call's block work runs on (a mesh: one device per
rank, a device may repeat), and the one loop that queues its shares.

A run of rows (the full blocks, a table-log group) splits into one
contiguous ``Share`` per mesh entry. As the JAX package's one SPMD call
over the mesh runs every chip at once, ``frame`` queues every share's work
on its own device (``dispatch``) before the host waits for any, then
drains the shares in block order (``drain``), so one share's host work
overlaps the device work of the shares after it. Each dispatch and drain
is a range, ``ect.<op>.share_dispatch.<rank>`` / ``.share_drain.<rank>``:
a round of them runs in rising rank.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.profiler import record_function as _stage

from .ops.unsigned import resolve_device


class Share(NamedTuple):
    """Rows ``lo:hi`` of a run, on mesh entry ``rank``, its ``device``."""
    rank: int
    device: torch.device
    lo: int
    hi: int


def devices(mesh) -> tuple[torch.device, ...]:
    """A mesh checked as ``resolve_device`` checks one device: non-empty
    and of one device type."""
    mesh = tuple(resolve_device(d) for d in mesh)
    if not mesh:
        raise ValueError("empty mesh")
    if len({d.type for d in mesh}) > 1:
        raise ValueError(f"mesh mixes device types: {mesh}")
    return mesh


def of_call(device, sharding) -> tuple[torch.device, ...]:
    """The devices a frame call's block work runs on: ``sharding.mesh``
    or, without a sharding, ``device`` (default ``"cuda"``) alone. A
    ``device`` given beside a sharding must name the mesh's devices."""
    if sharding is None:
        return (resolve_device("cuda" if device is None else device),)
    mesh = devices(sharding.mesh)
    if device is not None:
        want = torch.device(device)
        if any(d.type != want.type or want.index not in (None, d.index)
               for d in mesh):
            raise ValueError(f"device={want} contradicts the sharding's "
                             f"mesh {mesh}")
    return mesh


def spans_cards(mesh) -> bool:
    """Whether ``mesh`` names several CUDA devices: then its h2d copies go
    out from pinned staging without blocking the host, so that the copies
    to every card run at once. A copy to one card (virtual ranks included)
    stays the pageable one, which the single-device path has always
    made."""
    return len({d for d in mesh if d.type == "cuda"}) > 1


def shares(n_rows: int, mesh) -> list[Share]:
    """Contiguous balanced row ranges, one per mesh entry, the rank the
    entry's index in ``mesh``; empty ones are left out (5 rows over 8
    devices give 5 shares)."""
    p = len(mesh)
    bounds = [i * n_rows // p for i in range(p + 1)]
    return [Share(i, d, bounds[i], bounds[i + 1]) for i, d in enumerate(mesh)
            if bounds[i + 1] > bounds[i]]


def dispatch(op: str, shares, fn, *per_share) -> list:
    """``fn(share, *items)`` for each share, the items its entries of the
    lists ``per_share``, each inside the share's dispatch range; returns
    what each call returned (the shares' handles), in order."""
    handles = []
    for share, *items in zip(shares, *per_share):
        with _stage(f"ect.{op}.share_dispatch.{share.rank}"):
            handles.append(fn(share, *items))
    return handles


def drain(op: str, shares, handles, fn, ready: str | None = None) -> list:
    """Every handle's ``ready()`` (inside the range ``ready`` when it is
    named: a pass that does nothing opens none), then ``fn(share, handle)``
    for each share in order, each inside the share's drain range; returns
    what each call returned."""
    with _stage(ready) if ready else contextlib.nullcontext():
        for h in handles:
            h.ready()
    got = []
    for share, h in zip(shares, handles):
        with _stage(f"ect.{op}.share_drain.{share.rank}"):
            got.append(fn(share, h))
    return got

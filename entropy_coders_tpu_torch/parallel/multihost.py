"""Multi-process frame pipeline (one process per host or per card).

Counterpart of ``entropy_coders_tpu/parallel/multihost.py`` on
``torch.distributed``:

* each process compresses the contiguous range of blocks it owns: local
  work on its own device, no cross-process traffic in the coding itself;
* the ordered gather of the variable-length sub-frames is two
  ``all_gather`` rounds (lengths, then max-padded bytes), after which every
  process assembles the identical global frame;
* decompression is the mirror: each process range-decodes only its owned
  blocks, optionally followed by the same gather to materialise the whole
  buffer everywhere.

The exchanged data are host bytes, as in the JAX package's DCN
``process_allgather``, so the process group runs on ``gloo`` (NCCL would
also refuse two ranks on one card). On the card each process uses
``cuda:{rank % device_count}`` unless ``device=`` or ``sharding=`` says
otherwise.
"""

from __future__ import annotations

import struct

import numpy as np
import torch
import torch.distributed as dist

from .. import frame as F
from .. import mesh as M

__all__ = [
    "init_distributed",
    "owned_blocks",
    "compress",
    "decompress",
]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     cpu_collectives: str | None = None,
                     backend: str = "gloo") -> None:
    """Join the process group at ``coordinator_address`` (``host:port``)
    as rank ``process_id`` of ``num_processes``. A no-op when the group is
    already initialised, or when no argument is given (a single process).

    ``cpu_collectives`` is the JAX package's keyword: ``"gloo"`` selects
    the gloo backend (the exchanged data are host bytes), and any other
    value raises ValueError; ``backend`` names the ``torch.distributed``
    backend directly."""
    if cpu_collectives is not None:
        if cpu_collectives != "gloo":
            raise ValueError(f"cpu_collectives={cpu_collectives!r}: only "
                             "'gloo' is supported")
        if backend != "gloo":
            raise ValueError(f"cpu_collectives='gloo' contradicts "
                             f"backend={backend!r}")
    if dist.is_initialized():
        return
    args = (coordinator_address, num_processes, process_id)
    if all(a is None for a in args):
        return
    if any(a is None for a in args):
        raise ValueError("init_distributed needs coordinator_address, "
                         "num_processes and process_id together")
    addr = coordinator_address.removeprefix("tcp://")
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=num_processes, rank=process_id)


def _world() -> tuple[int, int]:
    """(process count, this process's index); (1, 0) outside a group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def owned_blocks(n_blocks: int, num_processes: int | None = None,
                 process_id: int | None = None) -> tuple[int, int]:
    """Contiguous balanced block range [lo, hi) owned by this process."""
    p, i = _world()
    p = num_processes if num_processes is not None else p
    i = process_id if process_id is not None else i
    return i * n_blocks // p, (i + 1) * n_blocks // p


def _allgather(t: torch.Tensor) -> list[torch.Tensor]:
    p, _ = _world()
    if p == 1:
        return [t]
    out = [torch.empty_like(t) for _ in range(p)]
    dist.all_gather(out, t)
    return out


def _allgather_bytes(buf: bytes) -> list[bytes]:
    """Ordered allgather of one variable-length byte string per process
    (two rounds: int64 lengths, then max-padded payloads)."""
    lens = [int(t) for t in _allgather(torch.tensor([len(buf)]))]
    padded = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    padded[: len(buf)] = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
    return [t[:n].numpy().tobytes()
            for t, n in zip(_allgather(padded), lens)]


def _local_device(device, sharding):
    """``device`` as given; else, without a sharding, this process's card
    (``cuda:{rank % device_count}``), or ``"cuda"`` (which raises in
    ``frame``) on a machine without one."""
    if device is not None or sharding is not None:
        return device
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return torch.device("cuda", _world()[1] % count) if count else "cuda"


def compress(data, *, block_size: int = F.DEFAULT_BLOCK_SIZE,
             k: int = F.DEFAULT_K, checksum: bool = False, sharding=None,
             device=None, **kwargs) -> bytes:
    """Multi-process frame compression of ``data`` (the same bytes in every
    process, e.g. from a shared filesystem): each process compresses only
    the blocks it owns, the sub-frames are gathered, and every process
    returns the identical global frame, byte for byte the frame
    ``frame.compress`` makes in one process.

    ``sharding`` optionally spreads each process's own blocks over a mesh
    as in ``parallel.compress``. ``shared_table=True`` builds one table for
    the whole input: each process counts only its owned bytes, the 256
    int64 counters are gathered and summed (exact at any size), and every
    process normalises the identical global counts."""
    data = (np.frombuffer(bytes(data), np.uint8)
            if not isinstance(data, np.ndarray) else np.asarray(data, np.uint8))
    device = _local_device(device, sharding)
    total_len = len(data)
    n_blocks = -(-total_len // block_size) if total_len else 0
    lo, hi = owned_blocks(n_blocks)
    local = data[lo * block_size: min(hi * block_size, total_len)]

    shared_table = bool(kwargs.pop("shared_table", False))
    shared_hdr = b""
    if shared_table:
        counts = torch.from_numpy(np.bincount(local, minlength=256)
                                  .astype(np.int64))
        counts_all = torch.stack(_allgather(counts)).sum(dim=0).numpy()
        # the one policy copy (frame.resolve_shared_table) decides
        # degenerate fallbacks and default logs, so every process, and the
        # single-process path, agrees
        lanes = kwargs.get("lanes")
        if lanes is None:  # resolved as frame.compress resolves it
            lanes = M.of_call(device, sharding)[0].type == "cuda"
        s = F.resolve_shared_table(counts_all, total_len,
                                   kwargs.get("table_log"), lanes)
        if s is None:
            shared_table = False  # deterministic per-block RAW/RLE
        else:
            kwargs["shared_hist"] = s
            shared_hdr = F._write_header(*s)

    local_frame = F.compress(local, block_size=block_size, k=k,
                             shared_table=shared_table, checksum=checksum,
                             sharding=sharding, device=device, **kwargs)
    return _merge_frames(_allgather_bytes(local_frame), total_len,
                         block_size, k, checksum,
                         bool(kwargs.get("bit_pack", False)),
                         shared_hdr=shared_hdr if shared_table else None)


def _merge_frames(frames: list[bytes], total_len: int, block_size: int,
                  k: int, checksum: bool, packed: bool = False,
                  shared_hdr: bytes | None = None) -> bytes:
    """Concatenate per-process sub-frames (contiguous block ranges, same
    block_size/k) into one global frame. ``shared_hdr`` (FLAG_SHARED) is
    the global histogram header every sub-frame must carry verbatim."""
    entries, crcs, payloads = [], [], []
    n_blocks = 0
    for sub in frames:
        pf = F._parse_frame(sub)
        if pf.n_blocks == 0:
            continue
        if (pf.block_size != block_size or pf.k != k
                or pf.shared != (shared_hdr is not None)
                or pf.packed != packed):
            raise ValueError("multihost merge: sub-frame layout mismatch")
        if shared_hdr is not None and pf.shared_hdr != shared_hdr:
            raise ValueError("multihost merge: shared table mismatch")
        ent, sub_crcs, payload = F._subframe_parts(pf)
        entries.append(ent)
        if checksum:
            if sub_crcs is None:
                raise ValueError("multihost merge: missing crc table")
            crcs.append(sub_crcs)
        payloads.append(payload)
        n_blocks += pf.n_blocks
    if n_blocks != (total_len + block_size - 1) // block_size:
        raise ValueError("multihost merge: block count mismatch")
    parts = [F._frame_header(total_len, k, block_size, n_blocks,
                             shared_hdr is not None, checksum, packed)]
    if shared_hdr is not None:
        parts.append(struct.pack("<H", len(shared_hdr)) + shared_hdr)
    if entries:
        parts.append(np.concatenate(entries).astype("<u4").tobytes())
    if checksum and crcs:
        parts.append(np.concatenate(crcs).astype("<u4").tobytes())
    parts.extend(payloads)
    return b"".join(parts)


def decompress(frame: bytes, *, assemble: bool = True, sharding=None,
               device=None, **kwargs):
    """Multi-process decompression: each process decodes only the blocks
    it owns (range decode; no process touches another's sections).

    With ``assemble`` (default) the decoded ranges are gathered and every
    process returns the whole buffer. With ``assemble=False`` returns
    ``(byte_offset, local_bytes)``: the form that scales when the output
    stays split across processes."""
    pf = F._parse_frame(frame)
    lo, hi = owned_blocks(pf.n_blocks)
    start = lo * pf.block_size
    length = min(hi * pf.block_size, pf.total_len) - start
    local = (F._decompress_parsed(pf, start=start, length=length,
                                  sharding=sharding,
                                  device=_local_device(device, sharding),
                                  **kwargs)
             if length > 0 else b"")
    if not assemble:
        return start, local
    return b"".join(_allgather_bytes(local))

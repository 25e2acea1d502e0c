"""Frame-level statistics (counterpart of
``entropy_coders_tpu/utils/metrics.py``), read with the port's own frame
parser and header reader: a per-frame breakdown of the container format
(FORMAT.md), with the same fields as the JAX package's ``FrameStats``."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .. import frame as F

__all__ = ["FrameStats", "frame_stats"]



@dataclass
class FrameStats:
    total_len: int
    compressed_len: int
    n_blocks: int
    block_size: int
    k: int
    shared_table: bool
    mode_counts: dict
    header_bytes: int
    payload_bytes: int
    lane_size_table_bytes: int
    # per-block table logs of the FSE-coded blocks, as {log: count}: what
    # the "auto"/"fast" per-block policies chose
    table_log_counts: dict = field(default_factory=dict)

    @property
    def ratio(self) -> float:
        return self.compressed_len / max(self.total_len, 1)

    @property
    def overhead(self) -> float:
        """Container + header bytes as a fraction of the compressed size."""
        extra = self.compressed_len - self.payload_bytes
        return extra / max(self.compressed_len, 1)


def frame_stats(frame) -> FrameStats:
    """Parse a container frame's structure without decoding payloads: block
    modes, the table log of each FSE-coded block, header, lane-size-table
    and payload bytes."""
    # read at the call: ``frame`` imports this package while it loads
    mode_names = {F.MODE_FSE: "fse", F.MODE_RAW: "raw", F.MODE_RLE: "rle",
                  F.MODE_FSE_PL: "fse_pl"}
    pf = F._parse_frame(frame)
    mode_counts: dict = {}
    log_counts: dict = {}
    header_bytes = len(pf.shared_hdr)
    payload_bytes = 0
    lane_bytes = 0
    shared_log = (F._read_block_header(bytes(pf.shared_hdr))[1]
                  if pf.shared and pf.shared_hdr else None)
    for i in range(pf.n_blocks):
        mode = int(pf.modes[i])
        name = mode_names.get(mode, "?")
        mode_counts[name] = mode_counts.get(name, 0) + 1
        sec = bytes(pf.section(i))
        if mode in (F.MODE_FSE, F.MODE_FSE_PL):
            if pf.shared:
                if shared_log is not None:
                    log_counts[shared_log] = log_counts.get(shared_log, 0) + 1
            else:
                _, log2, rest = F._read_block_header(sec)
                log_counts[log2] = log_counts.get(log2, 0) + 1
                header_bytes += len(sec) - len(rest)
                sec = rest
        if mode == F.MODE_FSE_PL:
            if pf.packed:
                (cs_len,) = struct.unpack_from("<H", sec)
                n = 2 + (cs_len if cs_len else 2 * pf.k)
            else:
                n = 2 * pf.k
            lane_bytes += n
            sec = sec[n:]
        payload_bytes += len(sec)
    return FrameStats(
        total_len=pf.total_len,
        compressed_len=len(frame),
        n_blocks=pf.n_blocks,
        block_size=pf.block_size,
        k=pf.k,
        shared_table=pf.shared,
        mode_counts=mode_counts,
        header_bytes=header_bytes,
        payload_bytes=payload_bytes,
        lane_size_table_bytes=lane_bytes,
        table_log_counts=dict(sorted(log_counts.items())),
    )

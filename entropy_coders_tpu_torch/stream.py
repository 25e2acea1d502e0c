"""Bounded-memory file streaming over the container format (counterpart of
``entropy_coders_tpu/stream.py``).

``frame.compress``/``decompress`` materialize the whole buffer; these
wrappers process ``chunk_blocks`` blocks at a time, so host memory stays
O(chunk) whatever the file size. Every chunk is compressed as a
self-contained sub-frame whose block-table entries and payload bytes are
streamed into their final places: the frame header and tables are sized by
``n_blocks`` alone, known from the file size up front, so the table area is
reserved and patched once at the end. The file equals ``frame.compress`` of
the whole buffer, byte for byte. Output lands in a same-directory temp file
renamed over the destination only on success (a failure never destroys a
pre-existing archive). ``device`` is where the block work runs, as in
``frame.compress`` (default ``"cuda"``, which raises when CUDA is
unavailable).
"""

from __future__ import annotations

import mmap
import os
import secrets

import numpy as np

from . import frame as F

__all__ = ["compress_file", "decompress_file"]


def _mkstemp_for(dst_path):
    """Open a unique same-directory temp file for the atomic replace of
    ``dst_path``. The name is random, so concurrent writers of one
    destination never share or unlink each other's file. It is created at
    mode 0o666 with O_EXCL, so the caller's umask applies as for a plain
    ``open``. Returns ``(open binary file object, tmp_path)``; the fd is
    wrapped at once, so no exception can leak it."""
    dst = os.fspath(dst_path)
    d = os.path.dirname(dst) or "."
    prefix = os.path.basename(dst) + ".tmp."
    for _ in range(100):
        tmp_path = os.path.join(d, prefix + secrets.token_hex(8))
        try:
            fd = os.open(tmp_path,
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
        except FileExistsError:
            continue
        try:
            return os.fdopen(fd, "wb"), tmp_path
        except BaseException:
            os.close(fd)
            os.unlink(tmp_path)
            raise
    raise FileExistsError(f"could not create a unique temp file for {dst}")


def _discard(fout, tmp_path) -> None:
    """Close and remove a temp file after a failure."""
    try:
        fout.close()
    except OSError:
        pass
    try:
        os.unlink(tmp_path)
    except OSError:
        pass


def compress_file(src_path, dst_path, *, block_size: int = F.DEFAULT_BLOCK_SIZE,
                  k: int = F.DEFAULT_K, chunk_blocks: int = 64,
                  checksum: bool = False, bit_pack: bool = False,
                  table_log: int | str | tuple | None = None,
                  lanes: bool | None = None, device=None) -> int:
    """Stream-compress ``src_path`` into ``dst_path``; returns the
    compressed byte count. Host memory is O(chunk_blocks * block_size).
    ``shared_table`` is not supported (it needs a whole-file histogram
    before any block can encode; per-block tables are the streaming
    default)."""
    if chunk_blocks < 1:
        raise ValueError("chunk_blocks must be >= 1")
    if block_size < 16:
        raise ValueError("block_size must be >= 16")
    total_len = os.path.getsize(src_path)
    n_blocks = -(-total_len // block_size) if total_len else 0
    entries = np.zeros(n_blocks, np.uint32)
    crcs = np.zeros(n_blocks, np.uint32) if checksum else None
    hdr = F._frame_header(total_len, k, block_size, n_blocks, False,
                          checksum, bit_pack)
    table_len = 4 * n_blocks * (2 if checksum else 1)
    fout, tmp_path = _mkstemp_for(dst_path)
    done = 0
    try:
        with open(src_path, "rb") as fin, fout:
            fout.write(hdr)
            fout.write(b"\0" * table_len)  # reserved; patched at the end
            # one reusable, writable chunk buffer (torch warns on tensors
            # over read-only memory)
            buf = bytearray(chunk_blocks * block_size)
            while n := fin.readinto(buf):
                sub = F.compress(np.frombuffer(buf, np.uint8, count=n),
                                 block_size=block_size, k=k, lanes=lanes,
                                 table_log=table_log, checksum=checksum,
                                 bit_pack=bit_pack, device=device)
                pf = F._parse_frame(sub)
                ent, sub_crcs, payload = F._subframe_parts(pf)
                nb = pf.n_blocks
                entries[done: done + nb] = ent
                if checksum:
                    crcs[done: done + nb] = sub_crcs
                fout.write(payload)
                done += nb
            if done != n_blocks:
                raise ValueError("input changed size during compression")
            end = fout.tell()
            fout.seek(len(hdr))
            fout.write(entries.astype("<u4").tobytes())
            if checksum:
                fout.write(crcs.astype("<u4").tobytes())
        os.replace(tmp_path, dst_path)
    except BaseException:
        _discard(fout, tmp_path)
        raise
    return end


def decompress_file(src_path, dst_path, *, chunk_blocks: int = 64,
                    device=None) -> int:
    """Stream-decompress ``src_path`` into ``dst_path``; returns the raw
    byte count. The frame is memory-mapped (no full-frame copy), parsed
    once, and decoded ``chunk_blocks`` blocks at a time through the
    container's random access, each chunk straight into one reusable
    buffer. Output is written atomically (same-directory temp + rename)."""
    fout, tmp_path = _mkstemp_for(dst_path)
    try:
        with open(src_path, "rb") as fin:
            try:
                mm = mmap.mmap(fin.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError:  # empty file
                mm = b""
            pf = F._parse_frame(mm)
            with fout:
                buf = bytearray(min(chunk_blocks * max(pf.block_size, 1),
                                    pf.total_len))
                for b_lo in range(0, pf.n_blocks, chunk_blocks):
                    start = b_lo * pf.block_size
                    length = min((b_lo + chunk_blocks) * pf.block_size,
                                 pf.total_len) - start
                    n = F._decompress_parsed(pf, start=start, length=length,
                                             out=buf, device=device)
                    fout.write(memoryview(buf)[:n])
                total = fout.tell()
        if total != pf.total_len:
            raise ValueError("decoded length mismatch")
        os.replace(tmp_path, dst_path)
    except BaseException:
        _discard(fout, tmp_path)
        raise
    return total

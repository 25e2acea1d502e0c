"""The lane repack on the device, PyTorch + CUDA: lane words ``(B, W, k)``
<-> the wire's concatenated lane streams.

Counterpart of ``entropy_coders_tpu/ops/device_repack.py``, which keeps the
repack as XLA code and records that its scatter was slower than the host's
C++ on a TPU. That says nothing about an H100: here persistent warps turn
tiles of 32 lanes x 32 words through shared memory (``csrc/repack.cu``),
and on a CUDA device the container repacks on the card (``frame``), so
that the words never cross to the host.

Both wire forms are one function. Lane i of block b is a run of ``len``
bits starting at bit ``bit_off[b, i]`` of a flat byte buffer: ``len =
sizes[b, i]`` for bit-packed lanes (``FLAG_PACKED``), ``8 * ceil(sizes /
8)`` for byte-aligned lanes (FORMAT.md). Bit j of the run is bit ``j & 31``
of ``words[b, j >> 5, i]``. The offsets are a prefix sum of the lengths,
in int64 (a 512 MiB call passes 2^32 bits): ``lane_offsets`` takes it with
``torch.cumsum`` for the CPU path and the tools; on the card the kernels
take it themselves (``kernel_offsets_ref`` is their formulation in plain
PyTorch).

* ``lane_merge_device`` -> D1, ``ect_lane_merge``; ``lane_split_device`` ->
  D2, ``ect_lane_split``. A wrapper launches its kernels for CUDA tensors
  (two launches, the offsets and the repack, into ``torch.empty`` outputs;
  it raises if it cannot) and runs the plain PyTorch version for CPU
  tensors. ``MERGE_LAUNCHES``/``SPLIT_LAUNCHES`` count the wrapper calls
  that launch. Their bytes equal ``native.lane_merge_batch``/
  ``lane_split_batch``.
* ``lane_merge_ref``/``lane_split_ref`` are the plain versions, the JAX
  module's formulation batched over blocks: every lane word lands at bit
  offset ``bit_off + 32 * j`` of the stream through two scatter-adds on
  int64 (the bit ranges are disjoint, so the adds never carry); the split
  is two gathers at the same offsets and a shift-combine; ``_masked_words``
  cuts each lane at its length.
* ``merge_bits_device``/``split_bits_device`` carry the JAX names and
  signatures (one block, bit-packed) over the plain versions;
  ``merge_bits_np`` is the JAX name of the host merge's bytes.

What the masks pin: a bit-packed merge drops every bit at or above a lane's
size, as ``native``'s does, so words with guard bits set give the same
bytes. A byte-aligned merge copies a lane's last byte whole, as
``native``'s ``memcpy`` does: guard bits inside that byte reach the wire,
those above it do not (B2 leaves them all zero). The splits mirror this:
the byte-aligned one keeps a lane's last byte whole (the container checks
its dead bits), the bit-packed one masks to the size.
"""

from __future__ import annotations

import warnings

import torch

from ..kernels.launch import check as _check, launch as _launch
from . import pl_coder as PL
from .unsigned import as_int64, d2h, int64_to_u32, launched

__all__ = [
    "MERGE_LAUNCHES",
    "SPLIT_LAUNCHES",
    "bytes_on",
    "encode_lanes_merged",
    "lane_merge_device",
    "lane_merge_ref",
    "kernel_offsets_ref",
    "lane_offsets",
    "lane_split_device",
    "lane_split_ref",
    "merge_bits_device",
    "merge_bits_np",
    "split_bits_device",
]

MERGE_LAUNCHES = 0  # D1 launches since import (or since a caller reset it)
SPLIT_LAUNCHES = 0  # D2 launches


def _lens(sizes: torch.Tensor, pack_bits: bool) -> torch.Tensor:
    """Bits each lane takes on the wire, int64."""
    s = sizes.to(torch.int64).clamp(min=0)
    return s if pack_bits else ((s + 7) >> 3) << 3


def lane_offsets(sizes: torch.Tensor, pack_bits: bool, block_offs=None):
    """(bit_off (B, k) int64, offs (B + 1,) int64): each lane's first bit in
    the flat buffer and each block's first byte, with the total last. The
    blocks' payloads are laid end to end from byte 0, or start at the (B,)
    int64 byte offsets ``block_offs`` (``offs`` is then None)."""
    lens = _lens(sizes, pack_bits)
    within = torch.cumsum(lens, 1) - lens
    if block_offs is not None:
        return within + (block_offs.to(torch.int64) << 3)[:, None], None
    totals = (lens.sum(1) + 7) >> 3
    offs = torch.cat([totals.new_zeros(1), torch.cumsum(totals, 0)])
    return within + (offs[:-1] << 3)[:, None], offs


def kernel_offsets_ref(sizes: torch.Tensor, pack_bits: bool, block_offs=None):
    """The offsets as D1 and D2 take them on the card, in plain PyTorch:
    (bit_off, offs) as ``lane_offsets`` gives them, then ``goff (B, k /
    32)`` and ``nbytes (B,)``, the scan kernel's outputs. The scan kernel
    sums each 32-lane group, scans the group sums within the block
    (``goff``) and rounds the block's total up to bytes; a repack warp adds
    a shuffle scan of its group's 32 lengths and the block's first byte
    (``block_offs``, or the sum of ``nbytes`` before it, which the merge
    writes out as ``offs``)."""
    lens = _lens(sizes, pack_bits)
    B, k = lens.shape
    groups = lens.view(B, k // 32, 32)
    gsum = groups.sum(2)
    goff = torch.cumsum(gsum, 1) - gsum
    nbytes = (gsum.sum(1) + 7) >> 3
    in_group = torch.cumsum(groups, 2) - groups
    if block_offs is None:
        offs = torch.cat([nbytes.new_zeros(1), torch.cumsum(nbytes, 0)])
        first = offs[:-1]
    else:
        offs, first = None, block_offs.to(torch.int64)
    bit_off = (in_group + goff[:, :, None]).view(B, k) + (first << 3)[:, None]
    return bit_off, offs, goff, nbytes


def _masked_words(words: torch.Tensor, lens: torch.Tensor, W: int):
    """(B, W, k) int64 words with each lane's bits at and above ``lens``
    zeroed (the padded layout has whole words above the last zero, but the
    last partial word may carry guard bits), and the bits of each word
    still in the stream."""
    j = torch.arange(W, device=words.device).view(1, W, 1)
    rem = lens[:, None, :] - (j << 5)
    mask = torch.where(rem >= 32, 0xFFFFFFFF,
                       (torch.ones_like(rem) << rem.clamp(0, 31)) - 1)
    return words & mask, rem


def _word_offsets(bit_off: torch.Tensor, W: int) -> torch.Tensor:
    j = torch.arange(W, device=bit_off.device).view(1, W, 1)
    return bit_off[:, None, :] + (j << 5)


def lane_merge_ref(words, sizes, bit_off, n_out: int, *, pack_bits: bool):
    """Plain PyTorch version of D1: ``(n_out,)`` uint32, the flat buffer
    with every lane's bits in place and zeros elsewhere. Words that would
    land past ``n_out`` are dropped."""
    W = words.shape[1]
    v, rem = _masked_words(as_int64(words), _lens(sizes, pack_bits), W)
    off = _word_offsets(bit_off, W)
    d = torch.where(rem > 0, off >> 5, n_out).clamp(0, n_out)
    b = off & 31
    lo = (v << b) & 0xFFFFFFFF
    hi = v >> (32 - b)
    out = torch.zeros(n_out + 2, dtype=torch.int64, device=words.device)
    out.scatter_add_(0, d.reshape(-1), lo.reshape(-1))
    out.scatter_add_(0, (d + 1).reshape(-1), hi.reshape(-1))
    return int64_to_u32(out[:n_out])


def lane_split_ref(packed, sizes, bit_off, *, W: int, pack_bits: bool):
    """Plain PyTorch version of D2: ``(B, W, k)`` uint32 from the ``(n,)``
    uint32 flat buffer ``packed``. Reads past it give zeros."""
    n = packed.numel()
    pad = torch.cat([as_int64(packed), torch.zeros(2, dtype=torch.int64,
                                                   device=packed.device)])
    off = _word_offsets(bit_off, W)
    d = (off >> 5).clamp(0, n)
    b = off & 31
    w = (pad[d] >> b) | ((pad[d + 1] << (32 - b)) & 0xFFFFFFFF)
    return int64_to_u32(_masked_words(w, _lens(sizes, pack_bits), W)[0])


def merge_bits_device(words, sizes, *, W: int, OW: int):
    """Bit-pack one block's k lane streams: ``words (W, k) uint32`` +
    ``sizes (k,) int32`` -> ``(OW,) uint32`` packed stream (lane i at bit
    offset ``cumsum(sizes)[:i]``, LSB-first: byte-identical to
    ``pl_coder.lane_merge_bits``). ``OW`` >= total words + 1."""
    bit_off, _ = lane_offsets(sizes[None], True)
    return lane_merge_ref(words[None, :W], sizes[None], bit_off, OW,
                          pack_bits=True)


def split_bits_device(packed, sizes, *, W: int):
    """Inverse of ``merge_bits_device``: gather each lane's words out of
    the packed stream into the padded ``(W, k)`` layout."""
    bit_off, _ = lane_offsets(sizes[None], True)
    return lane_split_ref(packed, sizes[None], bit_off, W=W,
                          pack_bits=True)[0]


def merge_bits_np(words, sizes) -> bytes:
    """Host bytes of ``merge_bits_device``, the JAX name's host wrapper:
    one block's ``words (W, k)`` uint32 and ``sizes (k,)`` bits ->
    the bit-packed payload (``pl_coder.lane_merge_bits``, the C++ merge)."""
    return PL.lane_merge_bits(words, sizes)


def _check_lanes(words_shape, sizes, dev):
    B, W, k = words_shape
    if k % 128 or k >= 1 << 16:
        raise ValueError(f"k={k} must be a multiple of 128 below 65536")
    _check(sizes, "sizes", (B, k), torch.int32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def lane_merge_device(words, sizes, *, pack_bits: bool = False):
    """Merge B blocks' lane words into their wire payloads (D1's wrapper).

    words: (B, W, k) uint32 lane words, sizes: (B, k) int32 bits a lane
    (at most 32 * W), k a multiple of 128 below 65536.
    Returns (flat uint8, offs (B + 1,) int64), both on the words' device:
    block b's payload is ``flat[offs[b]: offs[b + 1]]``, byte for byte what
    ``native.lane_merge_batch`` gives (byte-aligned lanes, or bit-packed
    with ``pack_bits``, each block from a byte boundary). ``flat`` is
    allocated at its bound, 4 * B * W * k bytes, so that no size has to
    cross to the host first. Only ``flat[: offs[B]]`` is promised, and the
    rest of its last 4-byte word, which is zero; the bytes after that are
    whatever the allocation held.

    CUDA tensors launch D1 (two kernels: the offsets, then the merge; it
    raises if a launch fails) into ``torch.empty`` outputs; CPU tensors run
    ``lane_offsets`` and ``lane_merge_ref``."""
    global MERGE_LAUNCHES
    if words.dim() != 3:
        raise ValueError(f"words must be (B, W, k), got {tuple(words.shape)}")
    B, W, k = words.shape
    dev = words.device
    _check(words, "words", (B, W, k), torch.uint32, dev)
    _check_lanes(words.shape, sizes, dev)
    n_out = B * W * k
    if dev.type == "cpu":
        bit_off, offs = lane_offsets(sizes, pack_bits)
        out = lane_merge_ref(words, sizes, bit_off, n_out,
                             pack_bits=pack_bits)
        return out.view(torch.uint8), offs
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    if not n_out:  # no lane words: every size is 0
        return out.view(torch.uint8), torch.zeros(B + 1, dtype=torch.int64,
                                                  device=dev)
    # offs (B + 1), then the kernels' scratch: block bytes (B), group
    # offsets (B, k / 32)
    meta = torch.empty(2 * B + 1 + B * (k // 32), dtype=torch.int64,
                       device=dev)
    words, sizes = PL._aligned(words), PL._aligned(sizes)
    from ..kernels.build import load

    lib = load()
    with torch.cuda.device(dev):
        _launch(lib.ect_lane_merge, words.data_ptr(), sizes.data_ptr(),
                out.data_ptr(), n_out, meta.data_ptr(), B, W, k,
                int(pack_bits), torch.cuda.current_stream(dev).cuda_stream)
    MERGE_LAUNCHES += 1
    return out.view(torch.uint8), meta[: B + 1]


def lane_split_device(flat, block_offs, sizes, *, k: int, W: int,
                      pack_bits: bool = False):
    """Split wire payloads into B blocks' lane words (D2's wrapper).

    flat: 1-D uint8 tensor that holds the payloads (a multiple of 4 bytes
      long and 16-byte aligned, or it is copied into one that is);
    block_offs: (B,) int64 byte offset of each block's lane streams in it;
    sizes: (B, k) int32 bits a lane. The caller has checked that every
    block's streams lie inside ``flat`` (the container's framing checks);
    reads past it give zeros.
    Returns words (B, W, k) uint32, every row written, the rows and bits
    past a lane's stream zero: what ``native.lane_split_batch`` gives.

    CUDA tensors launch D2 (two kernels: the offsets, then the split; it
    raises if a launch fails) into a ``torch.empty`` output; CPU tensors
    run ``lane_offsets`` and ``lane_split_ref``."""
    global SPLIT_LAUNCHES
    if flat.dim() != 1 or flat.dtype != torch.uint8:
        raise ValueError("flat must be a 1-D uint8 tensor")
    dev = flat.device
    B = sizes.shape[0]
    block_offs = torch.as_tensor(block_offs, dtype=torch.int64).to(dev)
    _check(block_offs, "block_offs", (B,), torch.int64, dev)
    _check_lanes((B, W, k), sizes, dev)
    if flat.numel() % 4 or flat.data_ptr() % 16 or not flat.is_contiguous():
        padded = torch.zeros(-(-flat.numel() // 4) * 4, dtype=torch.uint8,
                             device=dev)
        padded[: flat.numel()] = flat
        flat = padded
    packed = flat.view(torch.int32).view(torch.uint32)
    if dev.type == "cpu":
        bit_off, _ = lane_offsets(sizes, pack_bits, block_offs)
        return lane_split_ref(packed, sizes, bit_off, W=W,
                              pack_bits=pack_bits)
    words = torch.empty((B, W, k), dtype=torch.int32, device=dev).view(
        torch.uint32)
    if words.numel():
        sizes = PL._aligned(sizes)
        goff = torch.empty(B * (k // 32), dtype=torch.int64, device=dev)
        from ..kernels.build import load

        lib = load()
        with torch.cuda.device(dev):
            _launch(lib.ect_lane_split, packed.data_ptr(), packed.numel(),
                    sizes.data_ptr(), block_offs.data_ptr(), goff.data_ptr(),
                    words.data_ptr(), B, W, k, int(pack_bits),
                    torch.cuda.current_stream(dev).cuda_stream)
        SPLIT_LAUNCHES += 1
    return words


def bytes_on(buffer, lo: int, hi: int, device,
             non_blocking: bool = False) -> torch.Tensor:
    """Bytes ``[lo, hi)`` of ``buffer`` (bytes, a bytearray, an ``mmap``, a
    numpy array: anything with the buffer protocol) as a uint8 tensor on
    ``device``, zero-padded to a multiple of 4 bytes: one copy, no
    intermediate ``bytes``. The source is only read.

    ``non_blocking`` stages the bytes for a CUDA device in pinned host
    memory and queues the h2d without waiting for it (as
    ``unsigned.to_device`` does), so that copies to several cards run at
    once; the pageable copy blocks the host until it is done."""
    n = hi - lo
    out = torch.zeros(-(-n // 4) * 4, dtype=torch.uint8, device=device)
    if n:
        with warnings.catch_warnings():  # a read-only buffer: never written
            warnings.simplefilter("ignore", UserWarning)
            src = torch.frombuffer(buffer, dtype=torch.uint8, count=n,
                                   offset=lo)
        pinned = non_blocking and out.device.type == "cuda"
        if pinned:
            src = torch.empty(n, dtype=torch.uint8, pin_memory=True).copy_(src)
        out[:n].copy_(src, non_blocking=pinned)
    return out


def encode_lanes_merged(blocks, norm_tables, *, k: int, L: int, W: int,
                        pack_bits: bool = False, tables=None):
    """B2 and, behind it on the same stream, the merge: raw blocks (B, n)
    uint8 and their (B, 256) normalized histograms (or ``tables``, their
    encode half already built: ``pl_coder.encode_lanes_norm``'s) -> the
    blocks' wire payloads, without the lane words leaving the device.

    Returns a zero-argument ``collect`` (as ``encode_lanes_norm(lazy=True)``
    does): it waits for the d2h of the sizes and the block offsets, queued
    here, then copies exactly the payload bytes into pinned memory, behind
    this call's kernels and not behind those queued after it, and returns
    host numpy ``(payload uint8 (total,), offs int64 (B + 1,), sizes int32
    (B, k))``: block b's payload is ``payload[offs[b]: offs[b + 1]]``. On
    the CPU the plain versions have already run."""
    dev = blocks.device
    if tables is None:
        tables = PL.tables_from_norm(norm_tables, L, dev, half="encode")
    words, sizes = PL.encode_call(blocks, tables, k=k, L=L, W=W)
    flat, offs = lane_merge_device(words, sizes, pack_bits=pack_bits)
    after = launched(dev)
    first = d2h([sizes, offs], after)

    def collect():
        sizes_h, offs_h = first.get()
        (flat_h,) = d2h([flat[: int(offs_h[-1])]], after, 1).get()
        return flat_h, offs_h, sizes_h

    return collect

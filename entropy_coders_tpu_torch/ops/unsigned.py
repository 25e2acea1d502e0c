"""Unsigned integers across numpy, PyTorch and the card, and where a call
runs.

The wire format and the tables are unsigned (u32 stream words, u32 decode
entries, u16 next states). PyTorch has ``torch.uint32``/``torch.uint16``
but few operations on them, so tensors of those types only ever move as
views of the signed type of the same width: every copy, transfer and
comparison runs on the signed view, and arithmetic widens to int64 first
(torch's ``>>`` on int32 is arithmetic, the wire's shifts are logical).

Every entry point runs on ``"cuda"`` unless its caller names another
device (``resolve_device``); the ``ops`` entries that take numpy arrays or
tensors follow their tensors' device (``entry_device``) and move numpy
inputs there through pinned memory (``entry_tensor``).

The copies between host and card go through here: ``to_device`` the h2d,
``d2h`` the d2h, queued on a card's copy streams (``COPY_STREAMS``)
behind an event (``launched``), so that the host waits for one copy and
not for the work queued after it.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

_SIGNED = {torch.uint32: torch.int32, torch.uint16: torch.int16}
_NP_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}
_NP_UNSIGNED = {torch.uint32: np.uint32, torch.uint16: np.uint16}
_TORCH_UNSIGNED = {np.dtype(np.uint32): torch.uint32,
                   np.dtype(np.uint16): torch.uint16}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: CUDA raises where
    it is not available (there is no fallback to the CPU), and only CUDA
    and the CPU (the plain versions) are taken."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available; pass "
                           "device='cpu' for the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(arr: np.ndarray, device, non_blocking: bool = False) -> torch.Tensor:
    """numpy array -> tensor on ``device``, u32/u16 kept as their type.

    ``non_blocking`` stages a copy for a CUDA device in pinned host memory
    and queues the h2d on the current stream without waiting for the work
    queued before it (a blocking h2d synchronises the stream). The staging
    copy is torch's (as ``Tensor.pin_memory`` makes it) from ``arr``'s own
    strides, so a strided or read-only array costs no other host copy."""
    arr = np.asarray(arr)
    signed = _NP_SIGNED.get(arr.dtype)
    src = arr if signed is None else arr.view(signed)
    if non_blocking and torch.device(device).type == "cuda":
        if any(s < 0 for s in src.strides):  # torch takes no negative stride
            src = np.ascontiguousarray(src)
        with warnings.catch_warnings():
            # torch warns of a read-only array; this view is only read
            warnings.simplefilter("ignore", UserWarning)
            host = torch.from_numpy(src)
        t = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        t = t.copy_(host).to(device, non_blocking=True)
    else:
        t = torch.from_numpy(np.ascontiguousarray(src)).to(device)
    return t if signed is None else t.view(_TORCH_UNSIGNED[arr.dtype])


# Side streams for the d2h copies, (card, role) -> stream, made on first
# use: role 0 takes the copies queued when work is dispatched, role 1 those
# queued when it is collected. A stream runs in order, so a copy queued by
# a collect on role 0 would wait behind the later dispatches' copies, and
# with them behind every kernel dispatched after its own.
COPY_STREAMS: dict[tuple[int, int], torch.cuda.Stream] = {}


def launched(dev: torch.device) -> torch.cuda.Event | None:
    """An event after the work queued so far on ``dev``'s current stream
    (the kernel just launched); None for the CPU, where nothing queues."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


class Later(NamedTuple):
    """The d2h of some tensors as ``d2h`` queued it: ``get()`` waits for
    that copy alone and returns them as host numpy. As a mesh share's
    handle (``mesh.drain``) it has nothing left to queue (``ready``)."""
    hosts: list
    wait: Callable[[], None]

    def ready(self) -> None:
        """Nothing: the copy is queued."""

    def get(self) -> list:
        self.wait()
        return [to_numpy(h) for h in self.hosts]


def d2h(tensors, after=None, role: int = 0) -> Later:
    """Queue the copy of CUDA ``tensors`` (all on one card) into pinned
    host buffers on copy stream ``role``, once event ``after`` (default:
    the work queued so far on their card) has passed; CPU tensors are not
    copied, ``get`` reads them. The handle's ``wait`` blocks on this copy's
    own event, not on a stream, so kernels queued later keep running. The
    sources stay referenced until ``wait()`` has seen the copy done, and
    each is ``record_stream``-ed on the copy stream, so the allocator does
    not hand its memory back before the copy has read it."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return Later(list(tensors), lambda: None)
    if (dev.index, role) not in COPY_STREAMS:
        COPY_STREAMS[dev.index, role] = torch.cuda.Stream(dev)
    cs = COPY_STREAMS[dev.index, role]
    cs.wait_event(launched(dev) if after is None else after)
    sources, hosts = list(tensors), []
    with torch.cuda.stream(cs):
        for t in sources:
            t.record_stream(cs)
            src = signed_view(t)
            h = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            hosts.append(h.copy_(src, non_blocking=True).view(t.dtype))
        done = torch.cuda.Event()
        done.record(cs)

    def wait():
        done.synchronize()
        sources.clear()

    return Later(hosts, wait)


def _tensors(xs):
    """The tensors among ``xs``, inside lists and tuples too."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def entry_device(device, *inputs) -> torch.device:
    """Where an ``ops`` entry runs: ``device``, or when it is None the
    device of the tensors among ``inputs`` (they must agree), and
    ``"cuda"`` when all are numpy (``resolve_device``)."""
    if device is None:
        devs = {x.device for x in _tensors(inputs)}
        if len(devs) > 1:
            raise ValueError("inputs lie on several devices: "
                             f"{sorted(map(str, devs))}; pass device=")
        device = devs.pop() if devs else "cuda"
    return resolve_device(device)


def entry_tensor(x, dtype, dev: torch.device) -> torch.Tensor:
    """A numpy array (cast to numpy ``dtype``, as the JAX entries cast) or
    a tensor (kept as it is: the wrappers reject a wrong dtype) as a
    contiguous tensor on ``dev``. A numpy array crosses to the card through
    pinned memory; on the CPU a read-only one (``np.asarray`` of a JAX
    array) is copied, where a writable one is shared."""
    if isinstance(x, torch.Tensor):
        return signed_view(x).to(dev).contiguous().view(x.dtype)
    arr = np.asarray(x, dtype)
    if dev.type == "cpu" and not arr.flags.writeable and arr.flags.c_contiguous:
        arr = arr.copy()
    return to_device(arr, dev, non_blocking=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy array, u32/u16 kept as their type."""
    signed = _SIGNED.get(t.dtype)
    if signed is None:
        return t.cpu().numpy()
    return t.view(signed).cpu().numpy().view(_NP_UNSIGNED[t.dtype])


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """The same memory as the signed type of equal width (u8 stays u8)."""
    signed = _SIGNED.get(t.dtype)
    return t if signed is None else t.view(signed)


def as_int64(t: torch.Tensor) -> torch.Tensor:
    """Widen to int64 by value: u32/u16 bit patterns read as unsigned."""
    signed = _SIGNED.get(t.dtype)
    if signed is None:
        return t.to(torch.int64)
    bits = 32 if t.dtype == torch.uint32 else 16
    return t.view(signed).to(torch.int64) & ((1 << bits) - 1)


def int64_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> a torch.uint32 tensor of the same
    values (through an exact int32 cast of the two's-complement value)."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32).view(
        torch.uint32)

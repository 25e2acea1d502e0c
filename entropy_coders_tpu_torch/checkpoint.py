"""Compressed checkpoints over the container format (counterpart of
``entropy_coders_tpu/checkpoint.py``; the ``FSCK`` file is byte-identical,
so a checkpoint written by either package loads in the other).

``save_pytree`` flattens a tree of tensors (a ``state_dict`` is one),
concatenates the leaf bytes and compresses them into one container frame
behind a small JSON manifest; ``load_pytree`` restores the tree with CPU
``torch.Tensor`` leaves, the counterpart of the JAX package's numpy leaves.
A ``Checkpoint`` handle parses the frame once and ``load_leaf`` decodes
only the blocks under one tensor's byte range.

File layout (little-endian):

    b"FSCK" | u8 version | u8 reserved | u16 reserved
    | u32 manifest_len | manifest (UTF-8 JSON) | container frame

Manifest: ``{"skel": <structure skeleton>, "leaves": [{"path", "dtype",
"shape", "offset", "nbytes"}, ...]}``, offsets into the decompressed byte
stream, ``dtype`` numpy's name of the leaf's type (``float32``,
``bfloat16``, ``int8``, ``bool``, ``float8_e4m3fn``, ...). Tree nodes:
dict (str keys), list, tuple, None. Leaves: a ``torch.Tensor`` on any
device (detached and copied to the host), a numpy array or a scalar
``np.asarray`` takes, of a type torch can hold; ``bfloat16`` and the fp8
types are read and written as torch's own, through byte views, so no
``ml_dtypes`` is needed. Any other type raises ``ValueError``. No pickle
is used, so a checkpoint cannot run code on load.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import numpy as np
import torch

from . import frame as F
from .stream import _discard, _mkstemp_for

__all__ = ["Checkpoint", "load_pytree", "save_pytree"]

_MAGIC = b"FSCK"
_VERSION = 1

# manifest dtype name (numpy's) -> the torch type that holds it
_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "uint16": torch.uint16, "int32": torch.int32,
    "uint32": torch.uint32, "int64": torch.int64, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "float8_e4m3fnuz": torch.float8_e4m3fnuz,
    "float8_e5m2fnuz": torch.float8_e5m2fnuz,
}
_NAMES = {t: name for name, t in _DTYPES.items()}


class _Leaf:
    """One leaf on its way to the payload: its path, manifest dtype name,
    shape and a flat uint8 tensor of its little-endian bytes (on the
    leaf's own device)."""

    def __init__(self, path: str, tree):
        where = path or "<root>"
        if isinstance(tree, torch.Tensor):
            t = tree.detach()
            if t.dtype not in _NAMES:
                raise ValueError(f"leaf dtype {t.dtype} at {where} has no "
                                 "checkpoint name")
            self.dtype, self.shape = _NAMES[t.dtype], list(t.shape)
            self.bytes = t.contiguous().reshape(-1).view(torch.uint8)
        else:
            arr = np.asarray(tree)
            if arr.dtype == object:
                raise TypeError(f"unsupported leaf type "
                                f"{type(tree).__name__} at {where}")
            if arr.dtype.name not in _DTYPES:
                raise ValueError(f"leaf dtype {arr.dtype.name} at {where} "
                                 "cannot be held by torch")
            self.dtype, self.shape = arr.dtype.name, list(arr.shape)
            arr = np.ascontiguousarray(arr)  # (0-d arrays come back 1-d)
            if arr.dtype.byteorder == ">":  # little-endian on the wire
                arr = arr.astype(arr.dtype.newbyteorder("<"))
            self.bytes = torch.from_numpy(arr.reshape(-1).view(np.uint8))
        self.path = path


def _flatten(tree, path, leaves):
    """Structure skeleton of ``tree`` with leaves replaced by indices into
    ``leaves`` (appended in deterministic traversal order)."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str):
                raise TypeError(
                    f"checkpoint dict keys must be str, got {type(k).__name__}"
                    f" at {'/'.join(path) or '<root>'}")
        keys = sorted(tree)  # deterministic bytes for identical trees
        return {"t": "dict", "k": keys,
                "v": [_flatten(tree[k], path + [k], leaves) for k in keys]}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "v": [_flatten(v, path + [str(i)], leaves)
                      for i, v in enumerate(tree)]}
    leaves.append(_Leaf("/".join(path), tree))
    return {"t": "leaf", "i": len(leaves) - 1}


def _unflatten(skel, leaves):
    t = skel["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _unflatten(v, leaves)
                for k, v in zip(skel["k"], skel["v"])}
    if t in ("list", "tuple"):
        seq = [_unflatten(v, leaves) for v in skel["v"]]
        return seq if t == "list" else tuple(seq)
    if t == "leaf":
        return leaves[skel["i"]]
    raise ValueError(f"corrupt manifest: unknown node type {t!r}")


def _restore_leaf(buf: bytearray, offset: int, meta) -> torch.Tensor:
    """The leaf ``meta`` from its bytes at ``offset`` of the writable
    ``buf``: a CPU tensor over that memory, or a copy where the offset is
    not a multiple of the element size. A malformed manifest raises
    ValueError, never a raw TypeError/IndexError/RuntimeError (the
    corruption contract of the frame)."""
    try:
        dt = _DTYPES.get(meta["dtype"]) if isinstance(meta["dtype"], str) \
            else None
        if dt is None:
            raise ValueError(f"leaf dtype {meta['dtype']!r} cannot be held "
                             "by torch")
        nbytes = meta["nbytes"]
        if nbytes == 0:
            flat = torch.empty(0, dtype=dt)
        else:
            flat = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes,
                                    offset=offset)
            if offset % dt.itemsize:
                flat = flat.clone()
            flat = flat.view(dt)
        return flat.reshape(meta["shape"])
    except (TypeError, KeyError, IndexError, RuntimeError) as e:
        raise ValueError(f"corrupt checkpoint manifest: {e!r}") from e


# --- save -------------------------------------------------------------------


def save_pytree(path, tree, *, align: int = 64, **compress_kw) -> int:
    """Compress ``tree`` into checkpoint file ``path``; returns the file
    size in bytes. ``compress_kw`` pass through to ``frame.compress``
    (``block_size``, ``k``, ``table_log``, ``checksum``, ``bit_pack``,
    ``lanes``, ``device``...). Leaves are packed at ``align``-byte offsets
    (zero padding), in one host buffer that CUDA leaves are copied into
    directly. The write is atomic: a same-directory temp file renamed over
    ``path`` only on success."""
    leaves: list[_Leaf] = []
    skel = _flatten(tree, [], leaves)
    metas, off = [], 0
    for leaf in leaves:
        off += (-off) % align
        nbytes = leaf.bytes.numel()
        metas.append({"path": leaf.path, "dtype": leaf.dtype,
                      "shape": leaf.shape, "offset": off, "nbytes": nbytes})
        off += nbytes
    payload = np.zeros(off, np.uint8)
    for leaf, meta in zip(leaves, metas):
        o = meta["offset"]
        torch.from_numpy(payload[o: o + meta["nbytes"]]).copy_(leaf.bytes)
    manifest = json.dumps({"skel": skel, "leaves": metas},
                          separators=(",", ":")).encode()
    comp = F.compress(payload, **compress_kw)
    fout, tmp_path = _mkstemp_for(path)
    try:
        with fout:
            fout.write(_MAGIC + struct.pack("<BBHI", _VERSION, 0, 0,
                                            len(manifest)))
            fout.write(manifest)
            fout.write(comp)
            total = fout.tell()
        os.replace(tmp_path, path)
    except BaseException:
        _discard(fout, tmp_path)
        raise
    return total


# --- load -------------------------------------------------------------------


class Checkpoint:
    """Open checkpoint handle: the file memory-mapped, manifest and frame
    parsed once (the frame as a ``memoryview`` of the map, never copied
    whole); ``load_leaf`` range-decodes only the blocks under one tensor.
    ``device`` is where the block work runs (``frame.decompress``'s).
    Usable as a context manager (closes the map)."""

    def __init__(self, path, *, device=None):
        self._device = device
        self._mv = self._mm = self._pf = None
        self._f = open(path, "rb")
        try:
            try:
                self._mm = mmap.mmap(self._f.fileno(), 0,
                                     access=mmap.ACCESS_READ)
            except ValueError:
                raise ValueError("truncated checkpoint: empty file")
            head = bytes(self._mm[:12])
            if len(head) < 12 or head[:4] != _MAGIC:
                raise ValueError("not an FSCK checkpoint")
            ver, _, _, mlen = struct.unpack_from("<BBHI", head, 4)
            if ver != _VERSION:
                raise ValueError(f"unsupported checkpoint version {ver}")
            if len(self._mm) < 12 + mlen:
                raise ValueError("truncated checkpoint: manifest")
            try:
                man = json.loads(bytes(self._mm[12: 12 + mlen]))
                self._skel = man["skel"]
                self._leaves = man["leaves"]
                self._by_path = {m["path"]: m for m in self._leaves}
            except (ValueError, KeyError, TypeError) as e:
                raise ValueError(f"corrupt checkpoint manifest: {e!r}") from e
            self._mv = memoryview(self._mm)
            self._pf = F._parse_frame(self._mv[12 + mlen:])
        except BaseException:
            self.close()
            raise

    @property
    def leaf_paths(self) -> list[str]:
        return [m["path"] for m in self._leaves]

    def leaf_meta(self, path: str) -> dict:
        """{"path", "dtype", "shape", "offset", "nbytes"} for one leaf."""
        if path not in self._by_path:
            raise KeyError(f"no leaf {path!r} in checkpoint")
        return dict(self._by_path[path])

    def load_leaf(self, path: str) -> torch.Tensor:
        """Decode one tensor: only the frame blocks overlapping its byte
        range are touched (O(tensor), not O(checkpoint))."""
        m = self.leaf_meta(path)
        try:
            buf = bytearray(m["nbytes"])
            F._decompress_parsed(self._pf, start=m["offset"],
                                 length=m["nbytes"], out=buf,
                                 device=self._device)
        except (TypeError, KeyError) as e:  # non-int offset/nbytes etc.
            raise ValueError(f"corrupt checkpoint manifest: {e!r}") from e
        return _restore_leaf(buf, 0, m)

    def load(self):
        """Decode the full tree (one whole-frame decompress, then every leaf
        a view of the decoded bytes)."""
        out = bytearray(self._pf.total_len)
        if self._pf.total_len:
            F._decompress_parsed(self._pf, out=out, device=self._device)
        try:
            for m in self._leaves:
                if m["offset"] < 0 or m["offset"] + m["nbytes"] > len(out):
                    raise IndexError(f"leaf {m['path']!r} outside the frame")
            leaves = [_restore_leaf(out, m["offset"], m) for m in self._leaves]
            return _unflatten(self._skel, leaves)
        except (TypeError, KeyError, IndexError) as e:  # corruption
            raise ValueError(f"corrupt checkpoint manifest: {e!r}") from e

    def close(self):
        self._pf = None
        for name in ("_mv", "_mm"):
            obj = getattr(self, name, None)
            if obj is not None:
                try:
                    obj.release() if name == "_mv" else obj.close()
                except BufferError:  # a live view of a range still exists
                    pass
                setattr(self, name, None)
        if getattr(self, "_f", None) is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def load_pytree(path, *, leaves=None, device=None):
    """Restore a checkpoint written by ``save_pytree`` (of either package).

    ``leaves=None``: the full tree. ``leaves=[names...]``: a dict
    ``{name: tensor}`` decoded through per-leaf range access (restoring a
    few layers of a huge checkpoint never decompresses the rest)."""
    with Checkpoint(path, device=device) as ck:
        if leaves is None:
            return ck.load()
        return {name: ck.load_leaf(name) for name in leaves}

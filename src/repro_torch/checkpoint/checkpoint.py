"""Checkpoints: MessagePack-serialized trees with a manifest and a sha256
(port of ``repro.checkpoint.checkpoint``, in its on-disk format).

``save(path, tree, step=, metadata=)`` writes ``path/payload.msgpack``
(through ``path/.payload.tmp`` and an atomic rename) and
``path/manifest.json`` (``step``, the payload's ``sha256``, ``metadata``);
``restore(path)`` checks the hash and returns ``(tree, manifest)``.  A
checkpoint written by either package restores in the other.  The payload is
the reference's packable tree, encoded by the in-repo codec
(``msgpack_codec``, the bytes ``msgpack.packb(..., use_bin_type=True)``
writes):

- a dict stays a map; a list or tuple (a NamedTuple such as ``FLState``
  too) becomes ``{"__seq__": <type name>, "items": [...]}`` and restores as
  a tuple when the name is ``"tuple"``, else as a list;
- a leaf (a tensor, a numpy array or scalar, a Python bool, int, float or
  complex) becomes ``{"__nd__": True, "dtype": <numpy dtype str>, "shape":
  [...], "data": <raw little-endian bytes>}``; a Python float or int is a
  0-d ``'<f8'`` or ``'<i8'`` leaf.

``restore`` gives the dtypes the reference's restore gives (its
``jnp.asarray`` runs with 64-bit types off): ``'<f8'`` comes back as f32,
``'<i8'`` as int32, ``'<u8'`` as uint32 and ``'<c16'`` as complex64, so
trees restored by either package are equal.  A bfloat16 leaf is refused at
save: the reference writes it as ``'<V2'`` and cannot restore it.  Strings
are refused for the same reason.

The payload is streamed: each leaf is copied to the host, written and
hashed on its own, so a save holds one leaf's host copy at a time; a
restore reads the file once into one buffer, hashes it as it reads, and
copies each leaf out of it to ``device`` (the GPU unless the caller asks
for the CPU).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import msgpack_codec as mp

_SENTINEL = "__nd__"
_READ = 1 << 26  # bytes per read of the payload
# restore's narrowing of 64-bit types, as jnp.asarray without x64
_NARROW = {"f8": np.float32, "i8": np.int32, "u8": np.uint32,
           "c16": np.complex64}
_SCALARS = (bool, int, float, complex, np.generic)


def _host_array(x) -> np.ndarray:
    """A leaf as a numpy array on the host (a tensor's own copy)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError(
                "cannot checkpoint a bfloat16 tensor: the reference writes it "
                "as dtype '<V2' and cannot restore it; cast it to float32")
        return x.detach().to("cpu").resolve_conj().numpy()
    arr = np.asarray(x)
    if arr.dtype.kind in "VUSO":
        raise TypeError(f"cannot checkpoint a leaf of dtype {arr.dtype} "
                        f"({arr.dtype.str}): the reference cannot restore it")
    return arr


def _write_leaf(x, write) -> None:
    arr = _host_array(x)
    shape = list(arr.shape)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    write(mp.map_header(4))
    for k, v in ((_SENTINEL, True), ("dtype", arr.dtype.str),
                 ("shape", shape)):
        mp.pack(k, write)
        mp.pack(v, write)
    mp.pack("data", write)
    mp.pack(memoryview(arr.reshape(-1)).cast("B"), write)


def _write_tree(tree, write) -> None:
    """Stream the reference's ``_to_packable(tree)`` into ``write``."""
    if isinstance(tree, dict):
        write(mp.map_header(len(tree)))
        for k, v in tree.items():
            mp.pack(k, write)
            _write_tree(v, write)
    elif isinstance(tree, (list, tuple)):
        write(mp.map_header(2))
        for piece in ("__seq__", type(tree).__name__, "items"):
            mp.pack(piece, write)
        write(mp.array_header(len(tree)))
        for v in tree:
            _write_tree(v, write)
    elif isinstance(tree, (torch.Tensor, np.ndarray) + _SCALARS):
        _write_leaf(tree, write)
    else:
        raise TypeError(f"cannot checkpoint {type(tree)}")


def _leaf(d: dict, device: torch.device) -> torch.Tensor:
    dtype = np.dtype(d["dtype"])
    if dtype.kind in "VUSO":
        raise TypeError(f"checkpoint leaf of dtype {d['dtype']} is not a "
                        "valid tensor type")
    arr = np.frombuffer(d["data"], dtype=dtype).reshape(d["shape"])
    target = np.dtype(_NARROW.get(dtype.str[1:], dtype)).newbyteorder("=")
    return torch.from_numpy(arr.astype(target, copy=True)).to(device)


def _from_packable(obj, device: torch.device):
    if isinstance(obj, dict) and obj.get(_SENTINEL) is True:
        return _leaf(obj, device)
    if isinstance(obj, dict) and "__seq__" in obj:
        seq = [_from_packable(v, device) for v in obj["items"]]
        return tuple(seq) if obj["__seq__"] == "tuple" else seq
    if isinstance(obj, dict):
        return {k: _from_packable(v, device) for k, v in obj.items()}
    raise TypeError(type(obj))


def save(path: str, tree: Any, *, step: int = 0,
         metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write ``tree`` as a checkpoint at ``path`` (a directory)."""
    os.makedirs(path, exist_ok=True)
    digest = hashlib.sha256()
    tmp = os.path.join(path, ".payload.tmp")
    with open(tmp, "wb") as f:
        def write(piece):
            f.write(piece)
            digest.update(piece)
        _write_tree(tree, write)
    os.replace(tmp, os.path.join(path, "payload.msgpack"))
    manifest = {"step": step, "sha256": digest.hexdigest(),
                "metadata": metadata or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def restore(path: str, device=None) -> Tuple[Any, Dict[str, Any]]:
    """``(tree, manifest)`` of the checkpoint at ``path``, its leaves on
    ``device`` (default the GPU); raises ``IOError`` when the payload's
    sha256 is not the manifest's."""
    dev = _device.resolve(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    name = os.path.join(path, "payload.msgpack")
    buf = bytearray(os.path.getsize(name))
    view = memoryview(buf)
    digest = hashlib.sha256()
    with open(name, "rb", buffering=0) as f:
        pos = 0
        while pos < len(buf):
            n = f.readinto(view[pos:pos + _READ])
            if not n:
                break
            digest.update(view[pos:pos + n])
            pos += n
    if pos != len(buf) or digest.hexdigest() != manifest["sha256"]:
        raise IOError(f"checkpoint corrupt: sha mismatch at {path}")
    tree = _from_packable(mp.unpackb(buf, bin_view=True), dev)
    return tree, manifest


def latest_step_dir(root: str) -> Optional[str]:
    """The ``step_<n>`` directory under ``root`` with the largest ``n``."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=lambda s: int(s.split("_")[1])))

"""Checkpointing: an npz tensor store with msgpack metadata, the format
of ``repro.checkpoint.io``, so a checkpoint written by either package
loads in the other.

Nests are flattened with '/'-joined key paths
(``repro_torch.tree.tree_flatten_with_path``: dict keys, sequence
indices, named-tuple field names; ``None`` subtrees skipped), the names
``jax.tree_util.tree_flatten_with_path`` gives. Leaves are tensors or
numpy arrays. Dtypes numpy lacks (bf16, fp8) are stored as a
same-width unsigned view with the true dtype named in the metadata, and
read back through ``Tensor.view``; the metadata blob is msgpack through
the port's own codec (``_msgpack``). Saves are crash-atomic: the bytes
go to a tmp file, are fsync'd and renamed over the target, and the
directory entry is fsync'd, so a crash mid-save can tear the tmp file
but never the checkpoint a later ``load_checkpoint`` trusts. Loads
raise ``CheckpointCorruptError`` (naming the path) on torn or truncated
files.

A flat load gives {path: numpy array}, except for the dtypes numpy
lacks, which come as CPU tensors of that dtype; ``assemble`` gives the
nest of ``like`` with tensor leaves on ``like``'s device (or on
``device``).
"""

from __future__ import annotations

import io
import os
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten_with_path, tree_unflatten

PyTree = Any
_META_KEY = "__repro_meta__"
_DTYPES_KEY = "__dtypes__"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed to parse: a torn write, a truncation, or
    not a checkpoint at all."""


# the dtypes numpy's savez cannot hold: stored as a same-width unsigned
# view; the bits pass between torch and numpy as a same-width integer
# both hold (torch's uint16 is not a full dtype): name -> (dtype, the
# stored view, the integer in numpy and in torch)
_VIEW_AS = {"bfloat16": (torch.bfloat16, np.uint16, np.int16, torch.int16),
            "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8,
                              torch.uint8),
            "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8,
                            torch.uint8)}
_VIEW_NAME = {v[0]: name for name, v in _VIEW_AS.items()}


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _leaf_array(leaf) -> tuple[np.ndarray, str | None]:
    """(the array savez stores, the true dtype's name where it is a
    view)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _VIEW_NAME.get(t.dtype)
        if name is None:
            return t.numpy(), None
        _, stored, _, bits = _VIEW_AS[name]
        return t.view(bits).numpy().view(stored), name
    arr = np.asarray(leaf)
    if arr.dtype.name in _VIEW_AS:                # ml_dtypes arrays
        return arr.view(_VIEW_AS[arr.dtype.name][1]), arr.dtype.name
    return arr, None


def _flatten(tree: PyTree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    out: dict[str, np.ndarray] = {}
    dtypes: dict[str, str] = {}
    for path, leaf in tree_flatten_with_path(tree):
        key = _path_str(path)
        out[key], name = _leaf_array(leaf)
        if name is not None:
            dtypes[key] = name
    return out, dtypes


def _pack(tree: PyTree, metadata: dict | None) -> dict[str, np.ndarray]:
    flat, dtypes = _flatten(tree)
    blob: dict = {_DTYPES_KEY: dtypes}
    if metadata is not None:
        blob["user"] = metadata
    flat[_META_KEY] = np.frombuffer(_msgpack.packb(blob), dtype=np.uint8)
    return flat


def _unpack(flat: dict[str, np.ndarray]) -> tuple[dict, dict | None]:
    meta = None
    dtypes: dict[str, str] = {}
    if _META_KEY in flat:
        blob = _msgpack.unpackb(flat.pop(_META_KEY).tobytes())
        dtypes = blob.get(_DTYPES_KEY, {})
        meta = blob.get("user")
    for key, name in dtypes.items():
        if key in flat:
            dtype, _, bits, _ = _VIEW_AS[name]
            flat[key] = torch.from_numpy(flat[key].view(bits)).view(dtype)
    return flat, meta


def save_checkpoint(path: str, tree: PyTree,
                    metadata: dict | None = None) -> None:
    flat = _pack(tree, metadata)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    # np.savez appends .npz to the filename it is given
    tmp = tmp + ".npz" if not tmp.endswith(".npz") else tmp
    # fsync before the rename: os.replace is atomic in the namespace, but
    # renaming a file whose bytes are still in the page cache can surface
    # as a zero-length or torn target after a power cut
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)          # persist the rename itself
    finally:
        os.close(dfd)


def dump_checkpoint_bytes(tree: PyTree,
                          metadata: dict | None = None) -> bytes:
    """The checkpoint as in-memory npz bytes: the format
    ``save_checkpoint`` writes, for moving weights without a file."""
    buf = io.BytesIO()
    np.savez(buf, **_pack(tree, metadata))
    return buf.getvalue()


def _read(source, origin: str) -> dict[str, np.ndarray]:
    try:
        with np.load(source, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (ValueError, OSError, EOFError, zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(
            f"{origin} is corrupt or truncated "
            f"({type(e).__name__}: {e})") from e


def load_checkpoint(path: str, like: PyTree | None = None
                    ) -> tuple[PyTree | dict, dict | None]:
    """Load a checkpoint. With ``like`` (a nest of the target structure)
    the arrays are assembled into that structure as tensors on the
    devices of ``like``'s leaves (``assemble``); otherwise the flat
    {path: array} dict is returned. Returns (tree_or_flat, metadata).
    Raises ``CheckpointCorruptError`` on a torn or truncated file."""
    flat, meta = _unpack(_read(path, f"checkpoint {path!r}"))
    if like is None:
        return flat, meta
    return assemble(flat, like), meta


def load_checkpoint_bytes(data: bytes, like: PyTree | None = None
                          ) -> tuple[PyTree | dict, dict | None]:
    """``load_checkpoint`` for in-memory npz bytes (the output of
    ``dump_checkpoint_bytes``). Raises ``CheckpointCorruptError`` on
    torn or truncated bytes."""
    flat, meta = _unpack(_read(io.BytesIO(data),
                               f"checkpoint bytes ({len(data)}B)"))
    if like is None:
        return flat, meta
    return assemble(flat, like), meta


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.require(a, requirements=("C", "W")))


def assemble(flat: dict, like: PyTree, device=None) -> PyTree:
    """Assemble a flat {path: array} dict (``load_checkpoint`` without
    ``like``) into the structure of ``like``, each leaf a tensor cast to
    the dtype of ``like``'s leaf, on ``device`` (default: the device of
    ``like``'s leaf; a leaf on the meta device needs ``device``)."""
    target = None if device is None else resolve_device(device)
    leaves = []
    for path, leaf in tree_flatten_with_path(like):
        key = _path_str(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing key {key!r}")
        arr = flat[key]
        ref = _as_tensor(leaf)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} "
                             f"!= expected {tuple(ref.shape)}")
        dev = target if target is not None else ref.device
        if dev.type == "meta":
            raise ValueError(f"{key}: like is on the meta device; pass "
                             f"device=")
        leaves.append(_as_tensor(arr).to(device=dev, dtype=ref.dtype))
    return tree_unflatten(like, leaves)

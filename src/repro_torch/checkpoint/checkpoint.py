"""Tree checkpointing in the JAX package's file format (npz payload + json
meta sidecar), so a checkpoint written by either package loads in the
other.

The tree is nested lists, tuples (named tuples: the Adam state), dicts and
leaves (``torch.Tensor`` or numpy arrays).  Leaves are flattened in the
JAX package's ``jax.tree.flatten`` order — list and tuple order, dict keys
sorted, a named tuple's fields in order (``mu``, ``nu``, ``count``) — and
stored as ``leaf_{i:05d}`` of ``ckpt_{step:08d}.npz``.  Dtypes numpy does
not have (bfloat16) are stored as the same-width unsigned view plus their
dtype name.  Writes are atomic (tmp + rename).

Integrity: the sidecar meta records a CRC32 of the npz payload bytes and
its length.  ``load_checkpoint`` validates them (raising
:class:`CheckpointCorruptError` on mismatch / truncation), and
``latest_step`` skips corrupt or partial checkpoints, falling back to the
newest valid one — so a crash mid-write or a damaged file degrades to
"resume from the previous step" instead of a mid-restore explosion.
"""
from __future__ import annotations

import json
import os
import re
import zlib

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "verify_checkpoint", "CheckpointCorruptError"]

_LEAF_KEY = "leaf_{:05d}"

_UINT_OF_WIDTH = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# torch dtypes numpy has no dtype for: (stored name, same-width int view)
_NON_NATIVE = {torch.bfloat16: ("bfloat16", torch.int16)}
_TORCH_OF_NAME = {name: dt for dt, (name, _) in _NON_NATIVE.items()}


class CheckpointCorruptError(RuntimeError):
    """Checkpoint payload failed integrity validation (bad checksum,
    truncated file, or missing/corrupt sidecar meta)."""


def _flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, leaves) -> object:
    """``leaves`` (an iterator) in the structure of ``like``."""
    if isinstance(like, dict):
        got = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: got[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(v, leaves) for v in like]
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    return next(leaves)


def _treedef(tree) -> str:
    """A ``PyTreeDef``-like rendering of the structure (the meta's
    ``treedef``, informational: loading reads the ``like`` tree)."""
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree))
        return "{" + inner + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(v) for v in tree)
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _encode(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array npz stores and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _NON_NATIVE:
            name, view = _NON_NATIVE[t.dtype]
            raw = t.view(view).numpy()
            return raw.view(_UINT_OF_WIDTH[raw.itemsize]), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _decode(raw: np.ndarray, dtype_name: str, like):
    """A stored leaf as ``like``'s kind: a tensor on ``like``'s device, or
    a numpy array."""
    if dtype_name in _TORCH_OF_NAME:
        # the same-width unsigned view, or the raw bytes (``|V2``) of a
        # file whose writer had a numpy bfloat16
        raw = raw.view(_UINT_OF_WIDTH[raw.dtype.itemsize])
        t = torch.from_numpy(raw.copy()).view(_TORCH_OF_NAME[dtype_name])
    else:
        arr = raw if raw.dtype.name == dtype_name else \
            raw.view(np.dtype(dtype_name))
        if not isinstance(like, torch.Tensor):
            return arr
        t = torch.from_numpy(arr.copy())
    if isinstance(like, torch.Tensor):
        return t.to(like.device)
    return t.float().numpy() if t.dtype in _NON_NATIVE else t.numpy()


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
    return crc


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    encoded = [_encode(leaf) for leaf in _flatten(tree)]
    payload = {_LEAF_KEY.format(i): raw for i, (raw, _) in enumerate(encoded)}
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    crc = _file_crc32(tmp)
    nbytes = os.path.getsize(tmp)
    os.replace(tmp, path)
    meta = {"step": step, "num_leaves": len(encoded),
            "dtypes": [name for _, name in encoded],
            "treedef": _treedef(tree),
            "payload_crc32": crc, "payload_bytes": nbytes}
    meta_path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.json")
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(meta_path + ".tmp", meta_path)
    return path


def verify_checkpoint(ckpt_dir: str, step: int) -> dict:
    """Validate one checkpoint's payload against its sidecar meta; returns
    the meta dict on success, raises :class:`CheckpointCorruptError` on
    a missing file, truncation, or checksum mismatch.  Metas written
    before checksums existed (no ``payload_crc32`` key) pass unchecked —
    old checkpoints stay loadable."""
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    meta_path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.json")
    if not os.path.isfile(path):
        raise CheckpointCorruptError(f"missing payload: {path}")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"missing/corrupt sidecar meta: {meta_path}: {e}") from e
    want_crc = meta.get("payload_crc32")
    if want_crc is None:
        return meta
    nbytes = os.path.getsize(path)
    if nbytes != meta.get("payload_bytes", nbytes):
        raise CheckpointCorruptError(
            f"{path}: truncated ({nbytes} bytes, "
            f"expected {meta['payload_bytes']})")
    got = _file_crc32(path)
    if got != want_crc:
        raise CheckpointCorruptError(
            f"{path}: checksum mismatch "
            f"(crc32 {got:#010x}, expected {want_crc:#010x})")
    return meta


def load_checkpoint(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like`` (validates leaf count/shapes
    and the payload checksum recorded at save time).  A leaf comes back
    as its ``like`` leaf's kind: a tensor on that tensor's device, or a
    numpy array."""
    meta = verify_checkpoint(ckpt_dir, step)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    leaves = _flatten(like)
    if meta["num_leaves"] != len(leaves):
        raise ValueError(f"{path} holds {meta['num_leaves']} leaves, the "
                         f"structure to restore has {len(leaves)}")
    with np.load(path) as data:
        restored = [_decode(data[_LEAF_KEY.format(i)], meta["dtypes"][i], l)
                    for i, l in enumerate(leaves)]
    for i, (r, l) in enumerate(zip(restored, leaves)):
        if tuple(r.shape) != tuple(np.shape(l)):
            raise ValueError(f"leaf {i}: shape {tuple(r.shape)} != "
                             f"expected {tuple(np.shape(l))}")
    return _unflatten(like, iter(restored))


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with a *valid* checkpoint.  Corrupt or partial entries
    (truncated payload, bad checksum, missing meta) are skipped with a
    warning, falling back to the next-newest valid one — leftover
    ``.tmp`` files from a crashed save never match at all."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted((int(m.group(1)) for f in os.listdir(ckpt_dir)
                    if (m := re.match(r"ckpt_(\d+)\.npz$", f))),
                   reverse=True)
    for step in steps:
        try:
            verify_checkpoint(ckpt_dir, step)
        except CheckpointCorruptError as e:
            import warnings
            warnings.warn(f"skipping corrupt checkpoint at step {step}: {e}",
                          RuntimeWarning, stacklevel=2)
            continue
        return step
    return None

"""Checkpointing: one file a leaf, an async writer, an atomic rename.

Counterpart of ``repro/checkpoint/checkpoint.py``, with its on-disk
layout: a directory a step holding

  MANIFEST.json      — step, extra metadata, the codec, each leaf's shape
                       and dtype
  leaf_xxxxx.npy.zst — one zstd-compressed array a leaf (``.npy.raw``,
                       uncompressed, where ``zstandard`` is not installed:
                       the manifest records the codec per checkpoint, and
                       reading a zstd checkpoint without the module raises)

Leaves are numbered in the reference's flattening order (dict keys
sorted, lists and tuples in order, a ``NamedTuple``'s fields in order), so
a tree of the reference's layout saved by either package loads in the
other. A ``LeafGroup`` is saved as its stacked leaf and restored as one
stacked tensor. A bfloat16 leaf is stored as its 16 bits (numpy has no
bfloat16) under the dtype name ``"bfloat16"``, the reference's.

Every leaf is copied to the host before ``save_checkpoint`` returns, so a
caller may update its tensors in place while a non-blocking save writes.
A leaf on a mesh (a DTensor) is gathered whole first, on every rank (a
collective: every rank saves together), and only rank 0 copies it to the
host and writes, in the same format; ``load_checkpoint(shardings=)`` places each leaf read on a
mesh, which may differ from the one that saved (the elastic restore).
The write goes to ``<path>.tmp`` and is renamed into place, so a
preemption mid-write never leaves a partial checkpoint under ``path``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import leaf_sharding
from repro_torch.models.params import LeafGroup, tree_flatten

_BF16 = "bfloat16"


def _zstd():
    """Lazy optional import: the zstandard module, or None if unavailable."""
    try:
        import zstandard
        return zstandard
    except ImportError:
        return None


def _unflatten(like, leaves):
    """``like``'s structure with the next leaves of the iterator ``leaves``,
    taken in ``tree_flatten``'s order."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        if isinstance(like, list):
            return out
        return type(like)(*out) if hasattr(like, "_fields") else type(like)(out)
    return next(leaves)


def _to_host(leaf, keep: bool = True) -> np.ndarray | None:
    """A copy of the leaf on the host (never a view of a tensor's memory):
    bfloat16 as its bits, ``uint16``. A leaf on a mesh (a DTensor) is
    gathered whole first, which is a collective; with ``keep`` False it is
    gathered and dropped, and nothing is copied (None)."""
    if isinstance(leaf, LeafGroup):
        parts = [_to_host(t, keep) for t in leaf]
        return np.stack(parts) if keep else None
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):          # a DTensor: its whole value
            leaf = leaf.full_tensor()
        if not keep:
            return None
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf) if keep else None


def host_leaves(tree) -> dict[str, np.ndarray] | None:
    """Every leaf of ``tree`` copied to the host, by its name on disk. Where
    leaves are on a mesh every rank calls this together (each leaf's
    gather is a collective) and rank 0 alone keeps the copies: the other
    ranks get None and never hold the state on the host."""
    named = {f"leaf_{i:05d}": leaf for i, leaf in enumerate(tree_flatten(tree))}
    keep = (not any(leaf_sharding(v) is not None for v in named.values())
            or dist.get_rank() == 0)
    host = {k: _to_host(v, keep) for k, v in named.items()}
    return host if keep else None


def save_checkpoint(path: str, tree, step: int, *, blocking: bool = True,
                    extra: dict | None = None) -> threading.Thread | None:
    """Save ``tree`` under the directory ``path``: every leaf copied to the
    host now, written (by a daemon thread unless ``blocking``) to
    ``path + ".tmp"`` and renamed to ``path``. Returns the thread, or None.
    A tree with leaves on a mesh is saved by every rank together and
    copied and written by rank 0 alone (the others return None)."""
    dtypes = {f"leaf_{i:05d}": (_BF16 if getattr(v, "dtype", None) == torch.bfloat16 else None)
              for i, v in enumerate(tree_flatten(tree))}
    host = host_leaves(tree)
    if host is None:
        return None

    def _write():
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        zstd = _zstd()
        codec = "zstd" if zstd is not None else "raw"
        ext = ".npy.zst" if zstd is not None else ".npy.raw"
        cctx = zstd.ZstdCompressor(level=3) if zstd is not None else None
        manifest = {"step": int(step), "extra": extra or {}, "codec": codec, "leaves": {}}
        for k, arr in host.items():
            raw = arr.tobytes()
            with open(os.path.join(tmp, k + ext), "wb") as f:
                f.write(cctx.compress(raw) if cctx is not None else raw)
            manifest["leaves"][k] = {"shape": list(arr.shape),
                                     "dtype": dtypes[k] or str(arr.dtype)}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == _BF16 else np.dtype(name)


def _from_host(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def load_checkpoint(path: str, like_tree, shardings=None) -> tuple[Any, int]:
    """Restore into the structure of ``like_tree`` (shapes must match, a
    ``LeafGroup`` at its stacked shape) -> (tree of new tensors, step).
    Each leaf keeps its saved dtype and goes to the device of its ``like``
    leaf (the CPU for a ``meta`` or non-tensor one); where ``shardings``
    (a tree of ``NamedSharding`` or None matching ``like_tree``) has a
    sharding, the leaf is placed on its mesh at it: on any mesh, whatever
    mesh saved (every rank reads the whole leaf and keeps its shard)."""
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves_like = tree_flatten(like_tree)
    shard_leaves = ([None] * len(leaves_like) if shardings is None
                    else tree_flatten(shardings))
    if len(shard_leaves) != len(leaves_like):
        raise ValueError(f"{len(shard_leaves)} shardings for {len(leaves_like)} leaves")
    codec = manifest.get("codec", "zstd")   # pre-codec manifests were zstd
    dctx = None
    if codec == "zstd":
        zstd = _zstd()
        if zstd is None:
            raise RuntimeError(f"checkpoint {path} is zstd-compressed but the optional "
                               "'zstandard' module is not installed")
        dctx = zstd.ZstdDecompressor()
    ext = ".npy.zst" if codec == "zstd" else ".npy.raw"
    out = []
    for i, like in enumerate(leaves_like):
        k = f"leaf_{i:05d}"
        meta = manifest["leaves"][k]
        dt = _np_dtype(meta["dtype"])
        with open(os.path.join(path, k + ext), "rb") as f:
            raw = f.read()
        if dctx is not None:
            raw = dctx.decompress(raw, max_output_size=int(np.prod(meta["shape"]) *
                                                          dt.itemsize) or 1)
        arr = np.frombuffer(raw, dtype=dt).reshape(meta["shape"])
        exp_shape = tuple(getattr(like, "shape", ()) or ())
        if tuple(arr.shape) != exp_shape:
            raise ValueError(f"shape mismatch for {k}: ckpt {arr.shape} vs model {exp_shape}")
        sh = shard_leaves[i]
        dev = getattr(like, "device", torch.device("cpu"))
        if torch.device(dev).type == "meta":
            dev = torch.device("cpu")
        t = _from_host(arr.copy(), meta["dtype"], dev)
        out.append(t if sh is None else sh.place(t))
    return _unflatten(like_tree, iter(out)), manifest["step"]


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[-1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")

"""Pytree checkpointing to .npz, in the reference's format
(``repro/checkpoint/checkpoint.py``): one array per leaf under its flatten
path (``k:params/k:layers/k:attn/k:wq``), bf16 widened losslessly to f32
on disk, a JSON ``__meta__`` entry, written atomically (tmp +
``os.replace``). A checkpoint either package writes restores in the other.

``save_packed`` / ``restore_packed`` write named packed buffers (what a KV
server snapshots, net/kvserver.py) with a JSON meta dict and no pytree
structure; ``latest_checkpoint`` finds the newest complete
``ckpt_<step>.npz`` in a directory, skipping ``*.tmp*`` leftovers and torn
files.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import path_str, tree_flatten_with_path, tree_unflatten

#: server snapshot filename stem: ckpt_<step>.npz
CKPT_PREFIX = "ckpt_"
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()  # npz stores no bf16; widening is lossless
    return t.numpy()


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    pairs, _ = tree_flatten_with_path(tree)
    return {path_str(path): _to_numpy(leaf) for path, leaf in pairs}


def _atomic_savez(path: str, arrays: dict[str, np.ndarray], meta: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    os.close(fd)
    try:
        np.savez(tmp, __meta__=json.dumps(meta), **arrays)
        # np.savez appends .npz to the filename it's given
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    finally:
        for cand in (tmp, tmp + ".npz"):
            if os.path.exists(cand):
                os.remove(cand)


def save_checkpoint(path: str, tree: Any, *, step: int = 0,
                    metadata: dict | None = None) -> None:
    _, treedef = tree_flatten_with_path(tree)
    meta = {"step": step, "treedef": repr(treedef), **(metadata or {})}
    _atomic_savez(path, _flatten(tree), meta)


def restore_checkpoint(path: str, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like``: shapes are validated, each
    leaf takes ``like``'s dtype and device."""
    pairs, treedef = tree_flatten_with_path(like)
    leaves = []
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        for p, ref in pairs:
            key = path_str(p)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {arr.shape} != "
                    f"{tuple(ref.shape)}")
            leaves.append(torch.from_numpy(np.array(arr, order="C"))
                          .to(device=ref.device, dtype=ref.dtype))
    return tree_unflatten(treedef, leaves), meta


def checkpoint_path(dirname: str, step: int) -> str:
    return os.path.join(dirname, f"{CKPT_PREFIX}{step}.npz")


def save_packed(path: str, arrays: dict, *, step: int = 0,
                metadata: dict | None = None) -> None:
    """Atomically write named packed buffers (tensors on any device, or
    numpy arrays) + JSON metadata. Names are free-form strings (the server
    uses ``kv:<i>``, ``state:<unit>:<i>``, ``round:<i>``)."""
    meta = {"step": step, "packed": True, **(metadata or {})}
    _atomic_savez(path, {k: _to_numpy(v) if isinstance(v, torch.Tensor)
                         else np.asarray(v) for k, v in arrays.items()}, meta)


def restore_packed(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Inverse of ``save_packed`` (numpy arrays). Raises on a torn or
    corrupt file — ``latest_checkpoint`` turns that into a skip."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return arrays, meta


def latest_checkpoint(dirname: str) -> Optional[str]:
    """Newest complete ``ckpt_<step>.npz`` under ``dirname``, or None:
    ``*.tmp*`` leftovers never match the name pattern, and a file that
    fails to load is skipped for the next-newest."""
    if not os.path.isdir(dirname):
        return None
    found = []
    for name in os.listdir(dirname):
        m = _CKPT_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(dirname, name)))
    for _, path in sorted(found, reverse=True):
        try:
            restore_packed(path)
        except Exception:
            continue
        return path
    return None

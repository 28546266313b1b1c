"""Checkpointing with async save.

Format, the reference package's: one ``.npz`` per checkpoint (``a0, a1,
...``) plus a JSON manifest (step, the leaves' key strings, their dtypes).
A tree is nested dicts, tuples and lists of tensors; a leaf's key string is its path as the reference's ``jax.tree_util.keystr``
writes it, ``['stack']['0']['attn']['wq']`` for a dict key and ``[0]`` for a
sequence index, leaves in sorted-key order.  So a checkpoint the reference
wrote restores here and the reverse (``models/transfer.py`` builds the
reference's parameter tree of a model).  Saves run on a background thread
after a synchronous copy to the host, so the train loop never blocks on disk.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree"]


def _leaves(tree, path: str = "") -> Iterator[tuple[str, Any]]:
    """``(key string, leaf)`` in the reference's flattening order (``None``
    is an empty subtree, as in jax)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(tree, values: Iterator):
    """``tree``'s structure with its leaves replaced, in flattening order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], values) for key in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(sub, values) for sub in tree)
    return next(values)


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """The array to store and the dtype name to record.  npz cannot keep
    bfloat16: it is widened to float32 (as the reference does) and recorded
    as ``bfloat16``."""
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy(), name


def save_pytree(path: str, tree, step: int = 0) -> None:
    arrays = {}
    manifest = {"step": step, "keys": [], "dtypes": []}
    for i, (key, leaf) in enumerate(sorted(_leaves(tree))):
        arr, dtype = _to_numpy(leaf)
        manifest["dtypes"].append(dtype)
        arrays[f"a{i}"] = arr
        manifest["keys"].append(key)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def restore_pytree(path: str, target):
    """Restore into the structure of ``target``, a tree of tensors whose
    shapes, dtypes and devices the restored leaves take.  Returns ``(step,
    tree)``; raises ``KeyError`` for a leaf the file lacks and ``ValueError``
    for a shape that differs."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    out = []
    with np.load(path) as data:
        by_key = {k: f"a{i}" for i, k in enumerate(manifest["keys"])}
        for key, leaf in _leaves(target):
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[by_key[key]]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
            out.append(torch.from_numpy(arr).to(dtype=leaf.dtype, device=leaf.device))
    return manifest["step"], _rebuild(target, iter(out))


class CheckpointManager:
    """Directory of ``step_<n>.ckpt`` files; keeps the newest ``keep``."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.ckpt")

    def save(self, step: int, tree, blocking: bool = False) -> None:
        # snapshot to the host synchronously (the device may overwrite the
        # tensors in the next step), write async
        host = _rebuild(tree, (leaf.detach().to("cpu", copy=True) for _, leaf in _leaves(tree)))
        self.wait()

        def work():
            save_pytree(self._path(step), host, step)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            for suffix in ("", ".json"):
                try:
                    os.remove(self._path(s) + suffix)
                except FileNotFoundError:
                    pass

    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            m = re.match(r"step_(\d+)\.ckpt$", name)
            if m and os.path.exists(os.path.join(self.dir, name + ".json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def restore_latest(self, target):
        self.wait()
        steps = self.all_steps()
        if not steps:
            return None
        return restore_pytree(self._path(steps[-1]), target)

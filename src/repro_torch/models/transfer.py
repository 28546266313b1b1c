"""Carry the reference package's model weights into the port.

:func:`params_from_jax` takes the reference's parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, repro.models.init_model_params(
cfg, key))``) and returns the state dict of the port's
:class:`~repro_torch.models.transformer.Transformer` for the same config:
each stacked ``stack`` leaf is split along its leading ``n_superblocks`` axis
into one tensor per layer (an sLSTM block's ``r_zifo`` ``[n_superblocks, 4,
H, D, D]`` into ``[4, H, D, D]`` tensors, an mLSTM block's ``wq`` / ``wk``
``[n_superblocks, H, D, D]`` into ``[H, D, D]``); every other leaf (the
embedding, tied or not, the audio ``[K, V, d]`` / ``[K, d, V]`` tables,
zamba2's ``shared`` block and its tail blocks) keeps its name and shape.  A shared stack position holds no
leaves (``stack/<i>`` is ``{}`` in both packages).
It takes numpy, so it imports no jax.  :func:`params_tree` goes the other
way, to the reference's tree of a model (for checkpoints), and
:func:`load_params_tree` copies such a tree into a model in place.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .config import ModelConfig
from .layers import spec_leaves
from .transformer import Transformer, param_specs, state_items

__all__ = ["params_from_jax", "params_tree", "load_params_tree", "tree_leaves"]


def tree_leaves(tree, path: tuple = ()) -> Iterator[tuple[tuple, np.ndarray]]:
    """``(path, leaf)`` of a nested dict of arrays, keys in sorted order."""
    if not isinstance(tree, dict):
        yield path, tree
        return
    for key in sorted(tree):
        yield from tree_leaves(tree[key], (*path, key))


def params_from_jax(cfg: ModelConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The port's module state (CPU tensors, the arrays' dtypes) for the
    reference's parameter tree of ``cfg``.  Raises ``KeyError`` or
    ``ValueError`` when the tree does not match the config."""
    expected = Transformer(cfg, device="meta").state_dict()
    state = {}
    for path, leaf in tree_leaves(tree):
        arr = np.asarray(leaf)
        for name, part in state_items(path, arr):
            if name not in expected:
                raise KeyError(f"{'/'.join(path)}: no parameter {name!r} in the port's model")
            if tuple(part.shape) != tuple(expected[name].shape):
                raise ValueError(f"{name}: shape {part.shape}, expected {tuple(expected[name].shape)}")
            state[name] = torch.from_numpy(np.array(part, copy=True))
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"the tree lacks {missing}")
    return state


def params_tree(model: Transformer) -> dict:
    """The reference's parameter tree of ``model``: nested dicts with the
    reference's keys, each ``stack`` leaf the layers' tensors stacked on a new
    leading axis (a copy), every other leaf the parameter itself."""
    tree: dict = {}
    for path, _ in spec_leaves(param_specs(model.cfg)):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if path[0] == "stack":
            rest = ".".join(path[1:])
            node[path[-1]] = torch.stack([model.get_parameter(f"stack.{layer}.{rest}")
                                          for layer in range(model.cfg.n_superblocks)])
        else:
            node[path[-1]] = model.get_parameter(".".join(path))
    return tree


def load_params_tree(model: Transformer, tree: dict) -> None:
    """Copy a reference-shaped tree of tensors (:func:`params_tree`'s
    layout) into ``model``'s parameters in place (each keeps its device and
    dtype)."""
    with torch.no_grad():
        for path, leaf in tree_leaves(tree):
            for name, part in state_items(path, leaf):
                model.get_parameter(name).copy_(part)

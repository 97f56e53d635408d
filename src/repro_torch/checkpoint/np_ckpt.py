"""Flat-file checkpointing, tree <-> .npz (+ a JSON manifest): the port of
``repro.checkpoint.np_ckpt``, with its layout and key names, so that a
checkpoint written by either package restores in the other.

Arrays are keyed by their tree path (dict keys and list indices joined
with ``/``); bf16 (which numpy lacks) is stored as its uint16 bit
patterns with a dtype tag in ``<path>.meta.json``. Atomic via tmp +
rename.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.utils.trees import tree_flatten_with_path, tree_unflatten


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array, dtype tag)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def save_checkpoint(path: str, tree, step: int | None = None) -> None:
    arrays, dtypes = {}, {}
    for key, leaf in tree_flatten_with_path(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"dtypes": dtypes, "step": step}, f)


def restore_checkpoint(path: str, like_tree):
    """Restore into the structure of ``like_tree`` (shapes must match),
    each leaf on its like-leaf's device. Returns (tree, step)."""
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    leaves = []
    with np.load(path) as data:
        for key, like in tree_flatten_with_path(like_tree):
            a = data[key]
            if meta["dtypes"][key] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"restore_checkpoint: {key} is "
                                 f"{tuple(t.shape)} in {path}, expected "
                                 f"{tuple(like.shape)}")
            leaves.append(t.to(like.device))
    return tree_unflatten(like_tree, leaves), meta.get("step")

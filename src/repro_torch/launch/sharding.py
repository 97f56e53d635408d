"""Sharding rules: param/state/batch specs per architecture, the port of
``repro.launch.sharding``, rule for rule.

Tensor parallelism runs over the 16-way ``model`` axis on *feature*
dimensions (they divide 16 for every assigned arch; head counts often
don't). MoE experts shard on ``model`` (expert parallelism). Batch
shards on (``pod``, ``data``). ``fsdp=True`` additionally shards the
remaining large dim of every >=2-D param over ``data`` (ZeRO-3 style).

A spec is a tuple with one entry per dim, as a ``PartitionSpec`` is:
``None`` (replicated), a mesh-axis name, or a tuple of names (the dim
split over those axes, in the mesh's order). :func:`placements_of`
turns one into DTensor placements on a :class:`DeviceMesh` and
:func:`distribute` a tree of tensors into DTensors. Trees are the
port's nested dicts and lists (``models.carry`` carries them leaf for
leaf), so a leaf's path names are its dict keys and list indices.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils.partitioning import (axes_of, axis_sizes,
                                            contiguous_stride,
                                            placements_of)

# parent-module name -> role of its "w"
_COL = {"wq", "wk", "wv", "w_up", "w_gate", "w_uq", "w_dkv", "w_kr",
        "w_x", "w_gate_branch", "w_rec_gate", "w_in_gate", "w_in", "proj"}
_ROW = {"wo", "w_down", "w_out"}
_REPL = {"router"}


def map_with_names(fn, tree, names: tuple = ()):
    """``fn(names, leaf)`` over every leaf of a nested dict/list/tuple
    tree, ``names`` the path's dict keys and list indices as strings;
    the tree's structure kept."""
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_names(fn, v, names + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(list(names), tree)


def _P(*parts) -> tuple:
    """A spec, normalised as ``PartitionSpec`` normalises its entries: a
    one-name tuple is that name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in parts)


def _dp(mesh) -> tuple:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def _data_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _dp(mesh))


def _base_spec(names: list[str], ndim: int, dp: tuple,
               tied_embed: bool = False) -> tuple:
    """Spec ignoring any stacked leading layer dim (ndim = effective)."""
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    grandp = names[-3] if len(names) >= 3 else ""
    if name == "embed":
        # untied: the feature dim (the token gather needs no collective);
        # tied: the vocab, so the unembed product stays column-parallel
        return ("model", None) if tied_embed else (None, "model")
    if name == "unembed":
        return (None, "model")
    if name == "dec_pos":
        return (None, None)
    # MoE expert tensors: (E, d_in, d_out) under channel/
    if name in ("w_up", "w_gate", "w_down") and ndim == 3:
        return ("model", None, None)
    if ndim <= 1:
        return (None,) * ndim
    if parent in _REPL or name in _REPL:
        return (None,) * ndim
    if parent in _COL or (name == "w" and grandp in _COL) or name in _COL:
        return (None,) * (ndim - 1) + ("model",)
    if parent in _ROW or (name == "w" and grandp in _ROW) or name in _ROW:
        return (None,) * (ndim - 2) + ("model", None)
    if parent == "conv" or name == "conv":
        return (None,) * (ndim - 1) + ("model",)
    return (None,) * ndim


def _apply_fsdp(spec: tuple, shape, dp_axis: str, data_size: int) -> tuple:
    """Put the data axis on the first unsharded dim that divides."""
    parts = list(spec)
    for i, (s, dim) in enumerate(zip(parts, shape)):
        if s is None and dim % data_size == 0 and dim >= 1024:
            parts[i] = dp_axis
            break
    return tuple(parts)


def param_specs(params, mesh, *, fsdp: bool = False):
    """Spec tree mirroring ``params`` (tensors, meta tensors included)."""
    dp = _dp(mesh)
    tied_embed = isinstance(params, dict) and "unembed" not in params \
        and "embed" in params
    data = axis_sizes(mesh).get("data", 1)

    def spec_of(names, leaf):
        ndim = leaf.ndim
        stacked = "stack" in names
        eff = ndim - 1 if stacked else ndim
        base = _base_spec(names, eff, dp, tied_embed)
        spec = ((None,) + base) if stacked else base
        if fsdp and ndim >= 2:
            spec = _apply_fsdp(spec, tuple(leaf.shape), "data", data)
        return spec

    return map_with_names(spec_of, params)


def batch_specs(batch, mesh, *, shard_batch: bool = True):
    """Inputs: batch dim over (pod, data) when it divides; else
    replicated."""
    dp = _dp(mesh)
    data_size = _data_size(mesh)

    def spec_of(names, leaf):
        if not shard_batch or leaf.ndim == 0:
            return ()
        if leaf.shape[0] % data_size == 0:
            return _P(dp, *(None,) * (leaf.ndim - 1))
        return (None,) * leaf.ndim

    return map_with_names(spec_of, batch)


CACHE = ("k", "v", "c", "kr", "pos_abs", "cross_k", "cross_v")


def state_specs(states, mesh):
    """Decode-state sharding (mirrors ``models.layers.constrain_cache``):
    KV/latent caches shard batch over (pod, data) and cache-sequence
    over ``model`` (context parallelism); the B=1 long-context decode
    shards the sequence over ALL axes. Recurrent states (h/conv) shard
    their feature dims over ``model``."""
    dp = _dp(mesh)
    data_size = _data_size(mesh)
    tp_size = axis_sizes(mesh)["model"]

    def spec_of(names, leaf):
        if leaf.ndim == 0:
            return ()
        shape = leaf.shape
        parts = [None] * leaf.ndim
        name = names[-1] if names else ""
        if name in CACHE:
            if shape[0] == 1 and leaf.ndim >= 2 \
                    and shape[1] % (data_size * tp_size) == 0:
                parts[1] = dp + ("model",)          # B=1: seq over all
            else:
                if shape[0] % data_size == 0 and shape[0] > 1:
                    parts[0] = dp
                if leaf.ndim >= 2 and shape[1] % tp_size == 0:
                    parts[1] = "model"              # cache seq over model
            return _P(*parts)
        # recurrent states
        if shape[0] % data_size == 0 and shape[0] > 1:
            parts[0] = dp
        if name == "conv" and leaf.ndim == 3 and shape[2] % tp_size == 0:
            parts[2] = "model"
        if name == "h" and leaf.ndim == 4 and shape[1] % tp_size == 0:
            parts[1] = "model"   # SSD heads
        if name == "h" and leaf.ndim == 2 and shape[1] % tp_size == 0:
            parts[1] = "model"   # RG-LRU width
        return _P(*parts)

    return map_with_names(spec_of, states)


def local_shape(shape, spec: tuple, mesh, coords=None) -> tuple:
    """The shard of a tensor of global ``shape`` under ``spec`` held at
    mesh ``coords`` (rank 0's, all zeros, by default): each dim split
    over its axes in mesh order, ``torch.chunk``'s rule (the first
    shards take ceil(dim / n)), which at coordinate 0 is GSPMD's padded
    shard."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    coords = coords or {n: 0 for n in names}
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in sorted(axes_of(entry), key=names.index):
            n, k = sizes[a], coords[a]
            full = -(out[d] // -n)
            out[d] = max(0, min(full, out[d] - k * full))
    return tuple(out)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and its spec tree together (a
    spec is a tuple leaf of the spec tree)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_specs(fn, v, s) for v, s in zip(tree, specs)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, specs)


def distribute(tree, specs, mesh):
    """``tree``'s tensors as DTensors on ``mesh``, placed by ``specs`` (a
    spec tree of the same structure, as :func:`param_specs` gives): the
    port of ``shardings_of`` with the ``device_put`` it serves. Every
    rank holds the same global values and keeps its own shard of each
    (nothing sent; on a mesh of one device the tensor itself, no copy);
    a DTensor already is one, redistributed where its placements
    differ."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, s):
        pl = placements_of(s, mesh)
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == pl else t.redistribute(mesh,
                                                                      pl)
        if mesh.size() == 1:
            return DTensor.from_local(t, mesh, pl, run_check=False)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    return map_specs(one, tree, specs)


def abstract_distribute(tree, specs, mesh):
    """Stand-in DTensors of ``tree``'s (meta) tensors for the dry-run:
    each this rank's shard (:func:`local_shape` at its mesh coordinate),
    made with ``torch.empty`` in the ambient mode (a ``FakeTensorMode``
    gives fake tensors: nothing allocated), wrapped with the global
    shape the leaf has."""
    from torch.distributed.tensor import DTensor
    coord = mesh.get_coordinate()
    coords = dict(zip(mesh.mesh_dim_names, coord))

    def one(t, s):
        local = torch.empty(local_shape(tuple(t.shape), s, mesh, coords),
                            dtype=t.dtype, device=mesh.device_type)
        return DTensor.from_local(local, mesh, placements_of(s, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=contiguous_stride(t.shape))
    return map_specs(one, tree, specs)


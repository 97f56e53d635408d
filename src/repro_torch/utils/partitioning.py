"""The partitioning that is bound while a partitioned step runs, and the
spec-to-placement helpers that the model, the collectives and the
launcher share.

``launch.build.partitioning`` binds the logical axes (``dp`` the batch,
``tp`` the features, heads and experts) to a :class:`DeviceMesh`'s axis
names with :func:`set_partitioning`; the model's hooks
(``models.layers.constrain`` and the per-shard helpers) and
``comm.collectives.data_fabric`` read them here. Unbound, every hook is
a no-op and an axis name names no group.
"""
from __future__ import annotations

import contextlib

# logical axis -> mesh axis name(s), and the mesh they name
AXES: dict = {"dp": None, "tp": None, "mesh": None}


def set_partitioning(dp=None, tp=None, mesh=None):
    """Bind logical axes to mesh axis names (a tuple allowed for dp).
    ``mesh`` enables the expert-parallel MoE path."""
    AXES["dp"], AXES["tp"], AXES["mesh"] = dp, tp, mesh


@contextlib.contextmanager
def bound(dp=None, tp=None, mesh=None):
    """:func:`set_partitioning` for a block, the binding before restored
    after it."""
    before = dict(AXES)
    set_partitioning(dp, tp, mesh)
    try:
        yield
    finally:
        AXES.update(before)


def sub_mesh(mesh, names: tuple):
    """The sub-mesh of ``mesh`` over the axes ``names`` through this rank
    (several axes flattened into one), made with no tensor mode (a
    dry-run's fake tensors) in the way: it is bookkeeping."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return (mesh[names[0]] if len(names) == 1
                else mesh[tuple(names)]._flatten())


def bound_mesh():
    """The mesh :func:`set_partitioning` bound, or None."""
    return AXES["mesh"]


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, of a :class:`DeviceMesh` or a
    ``launch.mesh.AbstractMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return {n: int(mesh.size(i)) for i, n in enumerate(names)}


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_of(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim in
    mesh order: ``Shard(d)`` where tensor dim ``d`` names that axis, else
    ``Replicate()``. A dim over several axes takes them in the mesh's
    order, which is DTensor's default (and GSPMD's, for the tuples the
    rules make)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in axes_of(entry)]
        if idx != sorted(idx):
            raise ValueError(f"placements_of: {entry!r} is not in mesh "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(d)
    return tuple(reversed(stride))

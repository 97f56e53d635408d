"""Production meshes and the card's roofline constants: the port of
``repro.launch.mesh``.

A mesh is a ``torch.distributed`` :class:`DeviceMesh` over the default
process group, with the reference's shapes and axis names: (16, 16)
``("data", "model")``, or (2, 16, 16) ``("pod", "data", "model")``
across two pods. The functions build it on call, never at import: the
group must exist first (the dry-run's is a fake one of 256 or 512
ranks). :func:`abstract_mesh` is a stand-in with the same shape and
names and no group behind it, for the spec functions
(``launch.sharding``) and their tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.utils.partitioning import axis_sizes


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, no devices: ``shape[name]`` is the
    axis' size, ``axis_names`` the names in mesh order, ``size`` the
    device count (the port of ``compat.abstract_mesh``)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def abstract_mesh(shape, names) -> AbstractMesh:
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"abstract_mesh: shape {shape} and names {names}")
    return AbstractMesh(names, shape)


def default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape, names, device_type: str | None = None):
    """A :class:`DeviceMesh` of ``shape`` over the default process group
    (whose size must be the product), named ``names``; on the card
    unless ``device_type`` says otherwise."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or default_device_type(),
                            tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def data_axes(mesh) -> tuple:
    """The batch-parallel axes of a production mesh."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def make_worker_mesh(K: int, device_type: str | None = None):
    """1-D mesh for the CoCoA sharded driver."""
    return make_mesh((K,), ("workers",), device_type)


# Hardware constants: NVIDIA H100 80GB HBM3, 700 W power limit, data
# sheet (SXM part, dense rates), used by the roofline analysis.
PEAK_FLOPS_BF16 = 989e12          # per card
HBM_BW = 3.35e12                  # bytes/s per card
# NVLink, each way, per card (900 GB/s in both directions together). A
# model axis of 16 spans two 8-card NVLink hosts, whose inter-host half
# runs over the network at a fraction of this: the collective term is
# optimistic for it.
LINK_BW = 450e9


def kernel_roofline(flops: float, bytes_moved: float,
                    seconds: float) -> dict:
    """Achieved FLOP/s and bytes/s of one kernel cell against the card's
    peaks above."""
    return {
        "achieved_gflops": flops / seconds / 1e9,
        "achieved_gbps": bytes_moved / seconds / 1e9,
        "flops_frac_of_peak": flops / seconds / PEAK_FLOPS_BF16,
        "bw_frac_of_hbm": bytes_moved / seconds / HBM_BW,
    }

"""Multi-pod dry-run: every (arch x shape x mesh) combination's step run
on the production meshes in one process, and what each device would
hold, compute and send, for the roofline. The port of
``repro.launch.dryrun``.

The process joins a fake process group of 256 (16 x 16) or 512 (2 x 16
x 16) ranks as rank 0, builds the step with stand-in DTensors
(``launch.build``) and runs it under a ``FakeTensorMode``: every shape,
placement and collective is real, no tensor holds data. Rank 0's shards
are the largest (``torch.chunk``'s rule), as GSPMD's padded ones are.
It records, per device:

* bytes: arguments, outputs and aliased (the arguments the step writes
  or returns updated), exact from the local shards; peak live, the most
  bytes of local storage alive at once (the arguments included), from
  ``torch.distributed._tools.mem_tracker.MemTracker``, which tracks the
  fake tensors' storages;
* FLOPs: of the products (``torch.utils.flop_counter``'s formulas),
  counted on the local shards below DTensor's dispatch (a counter above
  it sees each op's global shapes, 256 times the device's work);
* bytes accessed: every local op's operand and result bytes, views
  left out (no fusion: an upper bound on what an H100 reads and
  writes), and those of the products alone (what a fully fused step
  would still read and write: a lower bound);
* collectives by kind, with operand and result bytes: DTensor's (its
  functional collectives) and the ``Fabric`` ones (the expert
  all-to-alls and the shared expert's all-reduce) from its log.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun \
      --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
      [--both-meshes] [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as tdist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import build
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import _period

_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}
_FABRIC = {"all_reduce": "all-reduce", "all_gather": "all-gather",
           "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
           "send": "send", "broadcast": "broadcast"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree's DTensors (and of its plain
    tensors, whole)."""
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class LocalCounter(TorchDispatchMode):
    """FLOPs, bytes accessed and collectives of the ops run on local
    shards. An op on DTensors is handed back (``NotImplemented``) to
    DTensor's dispatch, whose local ops then come here; the global-shape
    ops DTensor runs only to propagate shapes never reach it
    (:func:`_shape_propagation_muted`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.bytes_products = 0
        self.collectives: dict = {}

    def add_collective(self, kind: str, operand: int, result: int):
        c = self.collectives.setdefault(
            kind, {"count": 0, "operand_bytes": 0, "result_bytes": 0})
        c["count"] += 1
        c["operand_bytes"] += operand
        c["result_bytes"] += result

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            if name in _COLLECTIVES:
                self.add_collective(_COLLECTIVES[name], _nbytes(args[0]),
                                    _nbytes(out))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            def shape(t):
                return t.shape if isinstance(t, torch.Tensor) else t
            self.flops += int(flop_registry[packet](
                *tree_map(shape, args), **tree_map(shape, kwargs),
                out_val=tree_map(shape, out)))
        if not func.is_view:
            n = _nbytes((args, kwargs)) + _nbytes(out)
            self.bytes_accessed += n
            if packet in flop_registry:
                self.bytes_products += n
        return out


@contextlib.contextmanager
def _shape_propagation_muted():
    """Run DTensor's sharding propagator (which runs each new op on
    global fake shapes to learn its output's) with every mode of the
    stack put aside, so that neither the counter nor the memory tracker
    sees those global tensors (the propagator makes its own fake mode;
    it caches, so counting it would also depend on what ran before)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def muted(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)
    ShardingPropagator._propagate_tensor_meta_non_cached = muted
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (replacing
    one of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        if tdist.get_world_size() == world and \
                tdist.get_backend() == "fake":
            return
        tdist.destroy_process_group()
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world)


def measure(built: build.Built) -> dict:
    """Run ``built``'s step once under fake tensors and count what rank 0
    holds, computes and sends."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.comm.collectives import recording
    counter = LocalCounter()
    mem = MemTracker()
    mem.track_external(*(t for t in tree_flatten(built.args)[0]
                         if isinstance(t, torch.Tensor)))
    t0 = time.time()
    with recording() as log, _shape_propagation_muted(), mem, counter:
        out = built.run()
    t_run = time.time() - t0
    peak = sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    for c in log:
        result = {"all_gather": c.nbytes * c.K,
                  "reduce_scatter": c.nbytes // c.K}.get(c.op, c.nbytes)
        counter.add_collective(_FABRIC[c.op], c.nbytes, result)
    args_b = _local_bytes(built.args)
    aliased = sum(_local_bytes(built.args[i]) for i in built.donated)
    return {
        "t_run_s": round(t_run, 2),
        "per_device_bytes": {
            "arguments": args_b,
            "outputs": _local_bytes(out),
            "aliased": aliased,
            "peak_live": peak,
        },
        "flops": counter.flops,
        "bytes_accessed": counter.bytes_accessed,
        "bytes_products": counter.bytes_products,
        "collectives": counter.collectives,
        "collective_operand_bytes": sum(
            c["operand_bytes"] for c in counter.collectives.values()),
    }


def cycles_cfg(cfg, n_cycles: int):
    """``cfg`` cut to its dense prologue and ``n_cycles`` layer cycles."""
    k_dense = cfg.moe.first_k_dense if cfg.moe else 0
    return dataclasses.replace(cfg, num_layers=k_dense
                               + n_cycles * _period(cfg))


def _extrapolated(m1: dict, m2: dict, n: int) -> dict:
    """cost(L) = cost(L1) + (n - 1) * (cost(L2) - cost(L1)) for every
    count of two :func:`measure` records, exact for a stack whose
    cycles cost alike."""
    def ex(a, b):
        if isinstance(a, dict):
            return {k: ex(a[k], b[k]) for k in a}
        if isinstance(a, str):
            return a
        return a + (n - 1) * (b - a)
    out = ex({k: v for k, v in m1.items() if k != "collectives"},
             {k: v for k, v in m2.items() if k != "collectives"})
    kinds = set(m1["collectives"]) | set(m2["collectives"])
    zero = {"count": 0, "operand_bytes": 0, "result_bytes": 0}
    out["collectives"] = {k: ex(m1["collectives"].get(k, zero),
                                m2["collectives"].get(k, zero))
                          for k in sorted(kinds)}
    return out


def default_depth(cfg, shape) -> str:
    """``full`` for a decode step and for whisper (cheap to run whole);
    ``L1/L2`` for a train or prefill step of a layer stack."""
    return ("full" if shape.kind == "decode" or cfg.family == "audio"
            else "L1/L2")


def run_pair(arch: str, shape: str, *, multi_pod: bool, verbose: bool = True,
             **kw) -> dict:
    """One pair on the production mesh, at :func:`default_depth`:
    ``"full"`` runs every layer; ``"L1/L2"`` runs the prologue with one
    and with two layer cycles and extrapolates every count to the full
    depth (the reference roofline's rule), the argument and aliased
    bytes staying exact from the full config's shards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    cfg = build.shape_variant(get_config(arch), SHAPES[shape])
    if not build.supported(cfg, SHAPES[shape]):
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped",
                "reason": "long_context=skip (the reference's rule)"}
    depth = default_depth(cfg, SHAPES[shape])
    t0 = time.time()
    with FakeTensorMode():
        built = build.lower_pair(arch, shape, mesh, **kw)
        t_lower = time.time() - t0
        if depth == "full":
            m = measure(built)
        else:
            k_dense = cfg.moe.first_k_dense if cfg.moe else 0
            n = (cfg.num_layers - k_dense) // _period(cfg)
            m1, m2 = (measure(build.lower_cfg(cycles_cfg(cfg, c),
                                              SHAPES[shape], mesh, **kw))
                      for c in (1, 2))
            m = _extrapolated(m1, m2, n)
            m["t_run_s"] = round(m1["t_run_s"] + m2["t_run_s"], 2)
            m["per_device_bytes"]["arguments"] = _local_bytes(built.args)
            m["per_device_bytes"]["aliased"] = sum(
                _local_bytes(built.args[i]) for i in built.donated)
    rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
           "kind": built.kind, "status": "ok", "notes": built.notes,
           "depth": depth, "devices": mesh.size(),
           "t_lower_s": round(t_lower, 2), **m}
    if verbose:
        gb = 1 << 30
        b = m["per_device_bytes"]
        print(f"[{arch} x {shape} | {'2x16x16' if multi_pod else '16x16'} "
              f"| {built.kind} | {depth}] build {t_lower:.1f}s run "
              f"{m['t_run_s']}s", flush=True)
        print(f"  per-device: args {b['arguments'] / gb:.2f} GiB, outputs "
              f"{b['outputs'] / gb:.2f} GiB, aliased "
              f"{b['aliased'] / gb:.2f} GiB, peak live "
              f"{b['peak_live'] / gb:.2f} GiB")
        print(f"  flops/device {m['flops']:.3e}  bytes accessed/device "
              f"{m['bytes_accessed']:.3e} (products "
              f"{m['bytes_products']:.3e})")
        for k, c in sorted(m["collectives"].items()):
            print(f"  {k:15s} x{c['count']:<6d} operand "
                  f"{c['operand_bytes']:.3e} B", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    pairs = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in pairs:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'mp' if mp else 'sp'}"
            try:
                rec = run_pair(arch, shape, multi_pod=mp)
            except Exception as e:  # noqa: BLE001 -- listed, CLI exits 1
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "fail", "error": f"{type(e).__name__}: {e}"}
                failures.append(tag)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("all dry-runs OK")


if __name__ == "__main__":
    main()

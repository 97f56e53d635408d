"""The harness: finds a cell by name in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``, whose ``kind`` names the traffic generator
``traffic/<kind>.py``) and each metric's reader (``metrics/<metric>.py``),
runs it and prints the result line."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # cardbench/
ROOT = HERE.parent                                  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file whose name may hold dots (a metric's)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mod_name(kind: str, name: str) -> str:
    return "cardbench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise SystemExit(f"cardbench: no workload {name!r} in BENCHMARK.json "
                     f"(known: {[w['name'] for w in bench['workloads']]})")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def generator(kind: str):
    return load_module(HERE / "traffic" / f"{kind}.py",
                       mod_name("traffic", kind))


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py",
                       mod_name("metric", metric))


def metrics_of(bench: dict, wl_name: str, trace: bool) -> list:
    """The metrics a run of ``wl_name`` reports: the end-to-end ones
    without ``--trace``, the per-layer ones with it; a metric with a
    ``workloads`` key only in the cells it lists."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if wl_name in m.get("workloads", [wl_name])]


@dataclass
class Run:
    """What a traffic generator hands back: the clocks and trace of one run, and
    the comparison that decides ``correct``."""
    config: dict
    traffic: dict
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)
    ops: list = field(default_factory=list)
    trace: object = None
    info: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    checks: list = field(default_factory=list)    # (name, value, limit)

    @property
    def attempted(self) -> int:
        return len(self.ops)

    @property
    def failed(self) -> int:
        return sum(1 for op in self.ops if not op["ok"])

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v is not None and v == v and v <= lim for _, v, lim in self.checks)


@dataclass
class Context:
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float


def loaded_forbidden() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(bench: dict, ctx: Context, run: Run, kind: str,
                count: int) -> dict:
    from cardbench.harness.trace import breakdown
    metrics = {}
    for m in metrics_of(bench, ctx.workload["name"], ctx.trace):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if ctx.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = breakdown(run.trace)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return out


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="cardbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec()
    wl = workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"cardbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(wl, config(wl["config"]), traffic(wl["traffic"]),
                  args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    run = generator(ctx.traffic["kind"]).run(ctx)
    found = loaded_forbidden()
    if found:
        print(f"cardbench: the run loaded {found} (the JAX reference "
              f"or JAX); no result", file=sys.stderr)
        return 3
    line = result_line(bench, ctx, run, torch.cuda.get_device_name(0),
                       wl["chips"])
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def cache_dirs(root: Path = ROOT) -> None:
    """Every cache the run may write, at fixed paths in the checkout."""
    build = root / "build" / "cardbench"
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

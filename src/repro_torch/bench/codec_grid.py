"""Times K4's and K2's grid forms against their cluster forms on the card,
at the row lengths between webspam's and the transformer's leaves, for
the plans' rule (``kernels/topk.py::takes_grid``,
``kernels/quant.py::takes_grid``).

For each K in (1, 4, 8) and L in ``LENGTHS``: K4 (``topk_select``) at
k = ceil(r L) for r = 0.01 (the transformer's ``ef:topk``) and 0.125
(CoCoA's; not at the longest row, where the cluster form's scratch
would pass 40 GB), forced into the grid form and into the cluster form
the plan took before it (``survivors="device"`` keeps the cluster forms
and their resident-cluster rule), beside ``torch.topk(x.abs(), k,
sorted=True)``; K2 in each width, grid and cluster (``grid=False``, the
cluster plan). Each timing: CUDA events around ``REPS`` warm calls
(``event_ms``, a call as the caller sees it) and a ``torch.profiler``
trace of ``REPS`` more (``device_ms``: every kernel of the form, summed
and over the calls). At L up to 16,777,216 each form's outputs are held
against the plain version, bit for bit. x is N(0, 1) times 1e-3, f32, seeded.

    python src/repro_torch/bench/codec_grid.py      # on the card, ~2 min

Prints one JSON line per (K, L) and a last line with the card.
"""
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.join(ROOT, "src"))

LENGTHS = (350000, 1000000, 2097152, 4194304, 16777216, 22 * 2048 * 5632)
ROWS = (1, 4, 8)
RATIOS = (0.01, 0.125)
CHECKED_UP_TO = 16777216
REPS = 3
TOPK_NAMES = ("topk_kernel", "topk_grid_")


def quant_names(bits: int) -> tuple:
    per = 8 // bits
    return (f"quant_kernel<{per},", "quant_grid_init", "quant_grid_absmax",
            f"quant_grid_pack<{per}>")


def event_ms(torch, fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(torch, fn, names, reps: int = REPS) -> tuple:
    """The form's device ms a call, and a call's ms by kernel (the name
    up to its argument list)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and any(n in ev.name for n in names)):
            name = ev.name.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            by[name] = by.get(name, 0.0) + ev.time_range.elapsed_us()
    total = sum(by.values())
    return ((total / 1e3 / reps if total else "not measured"),
            {n: us / 1e3 / reps for n, us in by.items()})


def same(torch, got, want) -> bool:
    def b(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return all(torch.equal(b(x), b(y)) for x, y in zip(got, want))


def main() -> None:
    import torch

    from repro_torch.kernels import quant, topk
    dev = torch.device("cuda", 0)
    for K in ROWS:
        for L in LENGTHS:
            g = torch.Generator(device=dev).manual_seed(K * 7 + L)
            x = torch.randn((K, L), generator=g, device=dev) * 1e-3
            line = dict(K=K, L=L, topk={}, quant={})
            for r in RATIOS:
                if r > 0.01 and L > CHECKED_UP_TO:
                    continue
                k = math.ceil(r * L)
                forms = {"grid": lambda: topk.topk_select(x, k, grid=True),
                         "cluster": lambda: topk.topk_select(
                             x, k, survivors="device")}
                row = dict(k=k)
                for name, fn in forms.items():
                    fn()
                    dev_ms, by = device_ms(torch, fn, TOPK_NAMES)
                    row[name] = dict(
                        plan=topk.topk_select.last_plan.variant,
                        event_ms=event_ms(torch, fn), device_ms=dev_ms,
                        by_kernel=by)
                    if L <= CHECKED_UP_TO:
                        row[name]["equal_to_plain"] = same(
                            torch, fn(), topk.topk_select_ref(x, k))
                    torch.cuda.empty_cache()
                row["torch_topk_event_ms"] = event_ms(
                    torch, lambda: torch.topk(x.abs(), k, dim=1, sorted=True))
                line["topk"][f"r={r}"] = row
                torch.cuda.empty_cache()
            for bits in (8, 4, 2):
                enc = getattr(quant, f"quantize_pack_int{bits}")
                row = {}
                for name, grid in (("grid", True), ("cluster", False)):
                    fn = (lambda grid=grid: enc(x, grid=grid))
                    dev_ms, by = device_ms(torch, fn, quant_names(bits))
                    row[name] = dict(
                        plan=quant.quant_plan(K, L, bits, grid=grid).variant,
                        event_ms=event_ms(torch, fn), device_ms=dev_ms,
                        by_kernel=by)
                    if L <= CHECKED_UP_TO:
                        row[name]["equal_to_plain"] = same(
                            torch, fn(), getattr(
                                quant, f"quantize_pack_int{bits}_ref")(x))
                line["quant"][f"int{bits}"] = row
            print(json.dumps(line), flush=True)
            del x
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}))


if __name__ == "__main__":
    main()

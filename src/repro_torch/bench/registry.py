"""Benchmark registry: ``@benchmark("name")`` -> callable(ctx) -> result dict
(the port of ``repro.bench.registry``).

A module-level table plus a loader that imports the canonical benchmark
modules (which self-register on import). A registered benchmark is a
function taking a :class:`BenchContext` and returning a plain dict with
any of the keys

  ``params``     dict of workload parameters (m, n, K, H grid, ...)
  ``timings_s``  dict[str, float] of times in seconds — these are
                 what ``repro_torch.bench.compare`` gates on (lower is
                 better)
  ``counters``   dict[str, float|int] of informational scalars
                 (rounds_to_eps, communicated bytes, bounds, ...)
  ``rows``       list[dict] — the full per-point table
  ``notes``      list[str] — checks and caveats
  ``status``     "ok" (default) | "skipped"
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable

TIERS = ("smoke", "quick", "full")

# Canonical benchmark modules; importing each registers its benchmarks.
# The port registers none yet: its cells, and the modules that define
# them, come with the port's benchmark and are named here then.
DEFAULT_MODULES = ()


@dataclass(frozen=True)
class BenchContext:
    """Everything a registered benchmark may depend on at run time."""
    tier: str = "quick"             # smoke | quick | full
    seed: int = 0
    repeats: int | None = None      # timing reps override (None = tier default)
    timeout_s: float | None = None  # enforced by the runner, advisory here
    out_dir: str = "."

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(f"unknown tier {self.tier!r}; known: {TIERS}")


@dataclass(frozen=True)
class BenchSpec:
    name: str
    fn: Callable[[BenchContext], dict]
    figures: str = ""               # which paper figure(s) this reproduces
    description: str = ""
    tiers: tuple = TIERS            # tiers in which the runner includes it


_REGISTRY: dict[str, BenchSpec] = {}


def benchmark(name: str, *, figures: str = "", description: str = "",
              tiers: tuple = TIERS) -> Callable:
    """Decorator: register ``fn`` under ``name``. Re-registering the same
    name with a different function is an error (duplicate definitions);
    re-importing the same module is idempotent."""
    def deco(fn: Callable[[BenchContext], dict]):
        prev = _REGISTRY.get(name)
        if prev is not None and ((prev.fn.__module__, prev.fn.__qualname__)
                                 != (fn.__module__, fn.__qualname__)):
            raise ValueError(f"benchmark {name!r} already registered "
                             f"({prev.fn.__module__}.{prev.fn.__qualname__})")
        doc = (fn.__doc__ or "").strip()
        desc = description or (doc.splitlines()[0] if doc else "")
        _REGISTRY[name] = BenchSpec(name=name, fn=fn, figures=figures,
                                    description=desc, tiers=tuple(tiers))
        return fn
    return deco


def get(name: str) -> BenchSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown benchmark {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    return list(_REGISTRY)


def specs() -> list[BenchSpec]:
    return list(_REGISTRY.values())


def load_default_benchmarks() -> list[str]:
    """Import the canonical benchmark modules (registering them).
    Returns the list of registered names (none while ``DEFAULT_MODULES``
    is empty and nothing else registered a benchmark)."""
    import sys

    errors = []
    for mod in DEFAULT_MODULES:
        try:
            importlib.import_module(mod)
        except ImportError as e:  # pragma: no cover - depends on cwd
            errors.append(f"{mod}: {e}")
    if errors and not _REGISTRY:
        raise ImportError(
            "could not import any benchmark modules — run from the repo "
            "root (the benchmark modules must be importable):\n  "
            + "\n  ".join(errors))
    for err in errors:  # partial failure must not silently shrink the gate
        print(f"# warning: benchmark module failed to import: {err}",
              file=sys.stderr)
    return names()

"""Versioned, machine-readable benchmark results (the port of
``repro.bench.schema``).

One ``BENCH_<name>.json`` per benchmark per run. The file is the contract
between the runner, the compare tool, and CI artifacts — bump
``SCHEMA_VERSION`` on any incompatible change and teach ``load`` the old
shape if trajectories must stay comparable.

The layout is the reference's but for ``env``: the fingerprint of a
PyTorch/CUDA process (torch, CUDA and ``nvcc`` versions, the card's name
and power limit, the hash of the kernel sources, the allocator's
settings) where the reference records jax's. ``validate`` checks ``env``
against these fields, so a result of the reference fails ``load`` here
("env missing fields") as a result of the port fails there: a TPU or
jax-on-CPU time is never compared with a card's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform as _platform
import subprocess
from dataclasses import dataclass, field
from datetime import datetime, timezone

SCHEMA_VERSION = 1

_STATUSES = ("ok", "skipped", "timeout", "error")


def _run(cmd: list) -> str:
    """``cmd``'s standard output, or "" where it is absent or fails."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout if out.returncode == 0 else ""


def _power_limit() -> str:
    """The first card's power limit as ``nvidia-smi`` prints it
    ("700.00 W"), or ""."""
    line = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).strip().splitlines()
    return line[0].rsplit(",", 1)[1].strip() if line and "," in line[0] else ""


def _nvcc_release() -> str:
    """The release line of ``nvcc --version``, or "" without ``nvcc``."""
    from repro_torch.kernels import _build
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        return ""
    return next((ln.strip() for ln in _run([nvcc, "--version"]).splitlines()
                 if "release" in ln), "")


@dataclass(frozen=True)
class EnvFingerprint:
    """Enough environment to judge whether two results are comparable."""
    python: str
    torch: str
    cuda: str                  # torch.version.cuda, "" in a CPU build
    numpy: str
    platform: str
    device_kind: str           # the card's name, or "cpu"
    device_count: int
    cpu_count: int
    power_limit: str = ""      # nvidia-smi's, "" without a card
    nvcc: str = ""             # nvcc --version's release line
    kernels: str = ""          # the hash naming the kernel library
    alloc_conf: str = ""       # PYTORCH_CUDA_ALLOC_CONF

    @classmethod
    def capture(cls) -> "EnvFingerprint":
        """The running process's fingerprint. Builds no kernel, and needs
        neither a card, ``nvidia-smi`` nor ``nvcc``."""
        import numpy as np
        import torch

        from repro_torch.kernels import _build
        card = torch.cuda.is_available()
        return cls(
            python=_platform.python_version(),
            torch=torch.__version__,
            cuda=torch.version.cuda or "",
            numpy=np.__version__,
            platform=_platform.platform(),
            device_kind=torch.cuda.get_device_name(0) if card else "cpu",
            device_count=torch.cuda.device_count() if card else 1,
            cpu_count=os.cpu_count() or 1,
            power_limit=_power_limit() if card else "",
            nvcc=_nvcc_release(),
            kernels=_build._digest(),
            alloc_conf=os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""),
        )


@dataclass
class BenchResult:
    benchmark: str
    tier: str
    env: EnvFingerprint
    schema_version: int = SCHEMA_VERSION
    created_utc: str = ""
    status: str = "ok"
    wall_s: float = 0.0                      # total harness wall time
    params: dict = field(default_factory=dict)
    timings_s: dict = field(default_factory=dict)   # lower-is-better gates
    counters: dict = field(default_factory=dict)    # informational scalars
    rows: list = field(default_factory=list)        # full per-point table
    notes: list = field(default_factory=list)

    def __post_init__(self):
        if not self.created_utc:
            self.created_utc = datetime.now(timezone.utc).isoformat(
                timespec="seconds")

    # -- serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def write(self, out_dir: str = ".") -> str:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, result_filename(self.benchmark))
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path


def result_filename(benchmark: str) -> str:
    return f"BENCH_{benchmark}.json"


def validate(d: dict) -> list[str]:
    """Schema check on a loaded dict; returns a list of problems."""
    problems = []
    if d.get("schema_version") != SCHEMA_VERSION:
        problems.append(f"schema_version {d.get('schema_version')!r} "
                        f"!= {SCHEMA_VERSION}")
    for key, typ in (("benchmark", str), ("tier", str), ("status", str),
                     ("params", dict), ("timings_s", dict),
                     ("counters", dict), ("rows", list), ("notes", list),
                     ("env", dict)):
        if not isinstance(d.get(key), typ):
            problems.append(f"field {key!r} missing or not {typ.__name__}")
    if isinstance(d.get("status"), str) and d["status"] not in _STATUSES:
        problems.append(f"status {d['status']!r} not in {_STATUSES}")
    if isinstance(d.get("timings_s"), dict):
        for k, v in d["timings_s"].items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                problems.append(f"timings_s[{k!r}] is not a number")
    if isinstance(d.get("env"), dict):
        env_fields = {f.name for f in dataclasses.fields(EnvFingerprint)}
        missing = env_fields - set(d["env"])
        if missing:
            problems.append(f"env missing fields {sorted(missing)}")
    return problems


def load(path: str) -> BenchResult:
    """Load + validate one BENCH_*.json; raises ValueError on bad schema."""
    with open(path) as f:
        d = json.load(f)
    problems = validate(d)
    if problems:
        raise ValueError(f"{path}: invalid bench result: " + "; ".join(problems))
    env = EnvFingerprint(**{k: d["env"][k] for k in
                            (f.name for f in dataclasses.fields(EnvFingerprint))})
    known = {f.name for f in dataclasses.fields(BenchResult)} - {"env"}
    kwargs = {k: v for k, v in d.items() if k in known}
    return BenchResult(env=env, **kwargs)

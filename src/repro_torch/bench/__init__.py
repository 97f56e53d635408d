"""The benchmark harness of the port (the port of ``repro.bench``): the
measurement discipline its trade-off layer shares, and the machinery
that makes measurements on the card comparable across commits.

  * ``timing``    — warmup, repeat, reduce, a device that has finished
    its work inside every sample, and the link calibration that turns
    exchanged bytes into seconds.
  * ``registry``  — decorator-registered benchmarks.
  * ``schema``    — versioned ``BENCH_<name>.json`` results with a
    PyTorch/CUDA environment fingerprint (the card and its power limit).
  * ``run``       — ``python -m repro_torch.bench.run --smoke|--quick|--full``.
  * ``compare``   — ``python -m repro_torch.bench.compare old new
    --max-regression 1.25`` exits nonzero on regression so CI can gate.
  * ``bounds``    — the least time the card could take for a kernel's or
    a model's work; ``trace`` — CUDA-event and profiler device times.

The port registers no workload yet (``registry.DEFAULT_MODULES`` is
empty); this package is the machinery that will run them.
"""
from repro_torch.bench.registry import BenchContext, BenchSpec, benchmark, get, names  # noqa: F401
from repro_torch.bench.schema import SCHEMA_VERSION, BenchResult, EnvFingerprint  # noqa: F401

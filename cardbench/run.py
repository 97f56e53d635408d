"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA device of the machine it
is started on and prints one JSON line as the last line of its output.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

from cardbench.harness import core  # noqa: E402

if __name__ == "__main__":
    core.cache_dirs()
    sys.exit(core.main(sys.argv[1:], T_START))

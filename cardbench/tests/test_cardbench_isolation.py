"""No module of the benchmark loads JAX or the JAX package: every module
under cardbench/ is imported in a fresh process, and the top-level name
of each loaded module (before the first dot) is compared whole."""
import cardbench_fixtures  # noqa: F401  (puts the checkout on the path)
import os
import subprocess
import sys

from cardbench.harness import core

PROBE = r"""
import importlib, os, sys
root = sys.argv[1]
sys.path[:0] = [root, os.path.join(root, "src")]
from cardbench.harness import core
for d, _, files in os.walk(os.path.join(root, "cardbench")):
    if "__pycache__" in d:
        continue
    for f in sorted(files):
        if not f.endswith(".py") or f.startswith("conftest"):
            continue
        path = os.path.join(d, f)
        rel = os.path.relpath(path, root)[:-3]
        if rel.startswith(os.path.join("cardbench", "tests")):
            continue
        if "." in os.path.basename(rel) or rel.startswith(
                os.path.join("cardbench", "metrics")):
            core.load_module(core.Path(path), core.mod_name("probe", rel))
        else:
            importlib.import_module(rel.replace(os.sep, "."))
# the generators' lazy imports of the program under test
import repro_torch.core.cocoa, repro_torch.kernels.scd
names = sorted({n.split(".")[0] for n in sys.modules})
print(" ".join(names))
"""


def test_no_module_loads_jax_or_the_reference():
    out = subprocess.run([sys.executable, "-c", PROBE, str(core.ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert "cardbench" in loaded and "repro_torch" in loaded
    assert not loaded & set(core.FORBIDDEN), loaded & set(core.FORBIDDEN)


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert "repro" not in core.loaded_forbidden() or "repro" in {
        n.split(".")[0] for n in sys.modules}
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in core.loaded_forbidden()

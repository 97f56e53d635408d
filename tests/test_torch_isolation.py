"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or ``repro``, and its entry points run
on the card unless the caller asks for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import (CoCoAConfig, CoCoATrainer, MinibatchSCD,
                              MinibatchSGD, SGDConfig)
from repro_torch.utils.device import resolve_device

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _python_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.core.cocoa" in mods and "repro_torch.carry" in mods
    assert "repro_torch.core.baselines" in mods
    assert "repro_torch.launch.dist" in mods
    assert "repro_torch.analysis.traffic" in mods
    assert "repro_torch.comm.collectives" in mods
    for name in ("bench.timing", "core.tradeoff", "core.overheads",
                 "examples.quickstart", "examples.tune_h",
                 "configs.registry", "models.transformer", "models.carry",
                 "optim.local_updates", "train.step", "checkpoint.np_ckpt",
                 "data.tokens", "utils.trees", "launch.train",
                 "examples.train_lm", "configs.nemotron4",
                 "configs.command_r", "configs.mamba2",
                 "configs.recurrentgemma", "serve", "serve.decode",
                 "launch.serve", "examples.serve_lm", "analysis.findings",
                 "analysis.cells", "analysis.rules", "analysis.run"):
        assert f"repro_torch.{name}" in mods, name
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for name in {mods!r}:\n"
            "    importlib.import_module(name)\n"
            "from repro_torch.core import (dequantize_update,\n"
            "                              primal_from_state, quantize_update)\n"
            "from repro_torch.kernels import (decode_mean_int2,\n"
            "                                 decode_mean_int4, decode_mean_int8)\n"
            "from repro_torch.train import loss_and_grads\n"
            "assert not any(m == 'jax' or m.startswith('jax.') for m, v in "
            "sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", _python_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_or_repro(path):
    tree = ast.parse(open(path).read(), path)
    banned = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                banned.append(name)
    assert not banned, f"{path} imports {banned}"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    A = np.ones((4, 8), np.float32)
    b = np.ones(4, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CoCoATrainer(CoCoAConfig(K=2, H=2), A, b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MinibatchSCD(CoCoAConfig(K=2, H=2), A, b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MinibatchSGD(SGDConfig(K=2), A, b)
    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--steps", "1"])
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.main([])
    from repro_torch.analysis import run as analysis_run
    with pytest.raises(RuntimeError, match="device='cpu'"):
        analysis_run.main(["--cells", "codec", "--out", ""])
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")

"""The port's dry-run and roofline (``repro_torch.launch.dryrun``,
``.roofline``) on a fake 16 x 16 process group, in this process.

tinyllama-1.1b's decode step at decode_32k runs as rank 0 of 256 under
fake tensors: it must report ``ok``, and its per-device argument bytes
must equal a Python sum, over the reference's specs and shapes (one
subprocess of the reference, abstract meshes only), of the
ceil-divided shard bytes. The roofline of the same pair reads the same
counts against the H100's data-sheet constants.
"""
import math
import os
import pickle
import subprocess
import sys

import pytest
import torch
import torch.distributed as tdist

from repro_torch.launch import dryrun, mesh as M, roofline

ROOT = os.path.join(os.path.dirname(__file__), "..")

REFERENCE = r"""
import pickle, sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import SHAPES, get_config, input_specs
from repro.launch import build, sharding as sh
from repro.utils import compat

cfg, s = get_config("tinyllama-1.1b"), SHAPES["decode_32k"]
mesh = compat.abstract_mesh((16, 16), ("data", "model"))
_, params, states, tok, pos = build.abstract_decode_args(cfg, s, mesh)
leaves = []
for tree, specs in ((params, sh.param_specs(params, mesh, fsdp=False)),
                    (states, sh.state_specs(states, mesh)),
                    ({"t": tok, "p": pos}, sh.batch_specs({"t": tok, "p": pos},
                                                          mesh))):
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, P))):
        leaves.append((tuple(leaf.shape), np.dtype(leaf.dtype).itemsize,
                       tuple(spec) + (None,) * (leaf.ndim - len(spec))))
with open(sys.argv[1], "wb") as f:
    pickle.dump(leaves, f)
"""


@pytest.fixture(scope="module")
def ref_leaves(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dryrun") / "ref.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, path],
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def pair():
    """One dry-run and one roofline of tinyllama decode_32k; the fake
    group is taken down after, so that later tests may start their
    own."""
    torch.set_num_threads(1)
    try:
        rec = dryrun.run_pair("tinyllama-1.1b", "decode_32k",
                              multi_pod=False, verbose=False)
        roof = roofline.roofline_pair("tinyllama-1.1b", "decode_32k")
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    return rec, roof


def _shard_bytes(shape, itemsize, spec, sizes) -> int:
    n = itemsize
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n *= -(dim // -math.prod(sizes[a] for a in axes))
    return n


def test_decode_32k_dry_run_reports_ok_with_the_reference_argument_bytes(
        pair, ref_leaves):
    rec, _ = pair
    assert rec["status"] == "ok" and rec["depth"] == "full"
    assert rec["devices"] == 256 and rec["kind"] == "decode"
    want = sum(_shard_bytes(*leaf, {"data": 16, "model": 16})
               for leaf in ref_leaves)
    b = rec["per_device_bytes"]
    assert b["arguments"] == want
    # the step writes the states in place: they are its aliased bytes
    assert 0 < b["aliased"] < b["arguments"]
    # the arguments are live from the start; the step adds its own
    assert b["peak_live"] > b["arguments"]
    assert rec["flops"] > 0
    assert 0 < rec["bytes_products"] < rec["bytes_accessed"]
    # context parallelism: attention reduces over the model axis
    assert rec["collectives"]["all-reduce"]["count"] > 0


def test_roofline_terms_use_the_h100_constants(pair):
    rec, roof = pair
    assert roof["status"] == "ok" and roof["depth"] == "full"
    assert roof["compute_s"] == round(roof["flops_per_dev"] / 989e12, 6)
    assert roof["memory_s"] == round(roof["bytes_per_dev"] / 3.35e12, 6)
    assert roof["collective_s"] == round(roof["coll_bytes_per_dev"] / 450e9,
                                         6)
    assert roof["flops_per_dev"] == rec["flops"]
    assert roof["memory_products_s"] == round(rec["bytes_products"] / 3.35e12,
                                              6)
    assert roof["dominant_fused"] in ("compute", "memory", "collective")
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["model_flops_global"] == roofline.model_flops(
        roofline.get_config("tinyllama-1.1b"),
        roofline.SHAPES["decode_32k"])
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.LINK_BW) == (989e12, 3.35e12,
                                                        450e9)
    k = M.kernel_roofline(989e9, 3.35e9, 1e-3)
    assert k["flops_frac_of_peak"] == pytest.approx(1.0)
    assert k["bw_frac_of_hbm"] == pytest.approx(1.0)


def test_extrapolation_from_two_cycle_counts():
    m1 = {"flops": 10, "t_run_s": 1.0,
          "per_device_bytes": {"outputs": 100, "peak_live": 500},
          "collectives": {"all-reduce": {"count": 2, "operand_bytes": 8,
                                         "result_bytes": 8}}}
    m2 = {"flops": 16, "t_run_s": 1.0,
          "per_device_bytes": {"outputs": 130, "peak_live": 540},
          "collectives": {"all-reduce": {"count": 3, "operand_bytes": 12,
                                         "result_bytes": 12},
                          "all-gather": {"count": 1, "operand_bytes": 4,
                                         "result_bytes": 64}}}
    m = dryrun._extrapolated(m1, m2, 22)
    assert m["flops"] == 10 + 21 * 6
    assert m["per_device_bytes"] == {"outputs": 100 + 21 * 30,
                                     "peak_live": 500 + 21 * 40}
    assert m["collectives"]["all-reduce"] == {
        "count": 23, "operand_bytes": 92, "result_bytes": 92}
    assert m["collectives"]["all-gather"]["count"] == 21

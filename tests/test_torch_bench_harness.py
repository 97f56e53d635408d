"""The port's bench harness (``repro_torch.bench.{schema, registry, run,
compare}``) against the reference's (``repro.bench``) on the same
inputs, and the moved bounds (``repro_torch.bench.bounds``) pinned at
PERF.md's rows. Each package writes and reads its own files: their
``env`` fingerprints differ by design (torch/CUDA against jax), and a
result of one does not load in the other. No test here imports
``benchmarks`` or runs a workload."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.bench import compare as r_compare
from repro.bench import registry as r_registry
from repro.bench import run as r_run
from repro.bench import schema as r_schema
from repro_torch.bench import compare as t_compare
from repro_torch.bench import registry as t_registry
from repro_torch.bench import run as t_run
from repro_torch.bench import schema as t_schema
from repro_torch.bench.bounds import (bound_ms, codec_bounds, dense_products,
                                      state_bytes)
from repro_torch.configs import get_config
from repro_torch.launch.mesh import PEAK_FLOPS_BF16

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PACKAGES = {"ref": (r_schema, r_registry, r_run, r_compare),
            "port": (t_schema, t_registry, t_run, t_compare)}


@pytest.fixture(scope="module")
def envs():
    """Each package's own fingerprint of this process, captured once."""
    return {"ref": r_schema.EnvFingerprint.capture(),
            "port": t_schema.EnvFingerprint.capture()}


@pytest.fixture
def empty_registries(monkeypatch):
    """Both registries empty for the test, restored after it."""
    for reg in (r_registry, t_registry):
        monkeypatch.setattr(reg, "_REGISTRY", {})


def _result(schema, env, name="toy", timings=None, counters=None, **kw):
    return schema.BenchResult(benchmark=name, tier="smoke", env=env,
                              created_utc="2026-01-01T00:00:00+00:00",
                              timings_s=dict(timings or {}),
                              counters=dict(counters or {}), **kw)


def _same(a, b):
    """Equal, counting NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _deltas_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(_same(x, y) for x, y in zip(dataclasses.astuple(g),
                                               dataclasses.astuple(w))), (g, w)


# -- schema ----------------------------------------------------------------

def test_schema_constants_and_result_layout_match_the_reference(envs):
    assert t_schema.SCHEMA_VERSION == r_schema.SCHEMA_VERSION == 1
    assert t_schema._STATUSES == r_schema._STATUSES
    for name in ("drivers", "k1", "a_b-c"):
        assert t_schema.result_filename(name) == r_schema.result_filename(name)
    fields = [f.name for f in dataclasses.fields(t_schema.BenchResult)]
    assert fields == [f.name for f in dataclasses.fields(r_schema.BenchResult)]
    kw = dict(timings={"t": 0.5}, counters={"c": 3}, status="skipped",
              wall_s=1.25, params={"m": 16}, rows=[{"x": 1}], notes=["n"])
    got = _result(t_schema, envs["port"], **kw).to_dict()
    want = _result(r_schema, envs["ref"], **kw).to_dict()
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "env"} == {
        k: v for k, v in want.items() if k != "env"}


def test_fingerprint_on_the_cpu_names_no_card_and_builds_nothing(envs):
    env = envs["port"]
    assert [f.name for f in dataclasses.fields(env)] == [
        "python", "torch", "cuda", "numpy", "platform", "device_kind",
        "device_count", "cpu_count", "power_limit", "nvcc", "kernels",
        "alloc_conf"]
    assert env.torch == torch.__version__
    assert (env.cuda, env.device_kind, env.device_count) == (
        torch.version.cuda or "", "cpu", 1)
    assert env.power_limit == ""            # no card: nvidia-smi not asked
    from repro_torch.kernels import _build
    assert env.kernels == _build._digest() and len(env.kernels) == 16
    assert env.alloc_conf == os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    assert envs["ref"].device_kind == "cpu"  # jax's own name for its CPU


def _junk(env: dict) -> list:
    """Dicts each with one kind of fault (or none), over ``env``."""
    ok = dict(schema_version=1, benchmark="b", tier="smoke", status="ok",
              params={}, timings_s={"t": 0.1}, counters={}, rows=[],
              notes=[], env=env)
    short = dict(env)
    del short["device_kind"], short["cpu_count"]
    return [ok, {}, dict(ok, schema_version=2), dict(ok, status="weird"),
            dict(ok, timings_s={"a": "fast", "b": True, "c": 1}),
            dict(ok, params=[], rows={}, notes="n"),
            dict(ok, env=short), dict(ok, env="cpu"),
            dict(ok, benchmark=3, status=None, timings_s=None)]


def test_validate_lists_the_same_problems_as_the_reference(envs):
    got = [t_schema.validate(d)
           for d in _junk(dataclasses.asdict(envs["port"]))]
    want = [r_schema.validate(d)
            for d in _junk(dataclasses.asdict(envs["ref"]))]
    assert got == want
    assert got[0] == [] and any(got[1:])


def test_write_and_load_round_trip(tmp_path, envs):
    res = _result(t_schema, envs["port"], timings={"t": 0.25},
                  counters={"bytes": 7}, notes=["x"])
    path = res.write(str(tmp_path))
    assert os.path.basename(path) == "BENCH_toy.json"
    back = t_schema.load(path)
    assert back == res and back.env == envs["port"]


def test_results_do_not_load_across_packages(tmp_path, envs):
    """A jax result is not comparable with a card's: each ``load`` refuses
    the other's file for its ``env`` fields."""
    ref_path = _result(r_schema, envs["ref"]).write(str(tmp_path / "ref"))
    port_path = _result(t_schema, envs["port"]).write(str(tmp_path / "port"))
    with pytest.raises(ValueError, match="env missing fields") as e:
        t_schema.load(ref_path)
    for name in ("torch", "cuda", "power_limit", "nvcc", "kernels",
                 "alloc_conf"):
        assert repr(name) in str(e.value)
    with pytest.raises(ValueError, match="env missing fields") as e:
        r_schema.load(port_path)
    assert "'jax'" in str(e.value) and "'xla_flags'" in str(e.value)


# -- compare -----------------------------------------------------------------

PAIRS = [  # (old timings, new timings, old counters, new counters)
    ({"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 2.0}, {}, {}),
    ({"a": 1.0, "b": 2.0}, {"a": 1.3, "b": 1.0}, {}, {}),
    ({"a": 1.0}, {"a": 1.25}, {}, {}),                   # at the limit
    ({"tiny": 1e-6, "a": 0.01}, {"tiny": 5e-5, "a": 0.011}, {}, {}),
    ({"a": 1.0, "gone": 3.0}, {"a": 0.9, "new": 9.0}, {}, {}),
    ({"a": 1.0}, {"a": 1.0},
     {"bytes_x": 0, "bytes_y": 100, "flops": 5, "bytes_gone": 1},
     {"bytes_x": 4, "bytes_y": 100, "flops": 6, "bytes_new": 2}),
    ({"a": 1.0}, {"a": 1.0}, {"bytes_x": 0, "bytes_y": 3},
     {"bytes_x": 0, "bytes_y": 3}),
]


@pytest.mark.parametrize("pair", range(len(PAIRS)))
@pytest.mark.parametrize("limits", [(1.25, 1e-4), (1.1, 1e-3), (2.0, 0.0)])
def test_compare_results_and_counters_equal_the_reference(envs, pair, limits):
    t_old, t_new, c_old, c_new = PAIRS[pair]
    deltas = {}
    for key, (schema, _, _, cmp) in PACKAGES.items():
        old = _result(schema, envs[key], timings=t_old, counters=c_old)
        new = _result(schema, envs[key], timings=t_new, counters=c_new)
        deltas[key] = (cmp.compare_results(old, new, *limits),
                       cmp.compare_counters(old, new, ["bytes_"]),
                       cmp.compare_counters(old, new, ["bytes_", "flops"]))
    for got, want in zip(deltas["port"], deltas["ref"]):
        _deltas_equal(got, want)


def _write_side(root, schema, env, old, new):
    """BENCH files of ``old`` and ``new`` ({name: (timings, counters)})
    under root/old and root/new."""
    for side, results in (("old", old), ("new", new)):
        for name, (timings, counters) in results.items():
            _result(schema, env, name=name, timings=timings,
                    counters=counters).write(str(root / side))


CLI_CASES = {
    "equal": ({"k1": ({"t": 0.5}, {})}, {"k1": ({"t": 0.5}, {})}, []),
    "doubled": ({"k1": ({"t": 0.5}, {})}, {"k1": ({"t": 1.0}, {})}, []),
    "faster": ({"k1": ({"t": 0.5}, {})}, {"k1": ({"t": 0.1}, {})}, []),
    "floored": ({"k1": ({"t": 1e-6}, {})}, {"k1": ({"t": 9e-5}, {})}, []),
    "looser": ({"k1": ({"t": 0.5}, {})}, {"k1": ({"t": 0.7}, {})},
               ["--max-regression", "1.5"]),
    "counter_exact": ({"k1": ({"t": 0.5}, {"bytes_r": 8})},
                      {"k1": ({"t": 0.5}, {"bytes_r": 8})},
                      ["--exact-counter", "bytes_"]),
    "counter_moved": ({"k1": ({"t": 0.5}, {"bytes_r": 8})},
                      {"k1": ({"t": 0.5}, {"bytes_r": 9})},
                      ["--exact-counter", "bytes_"]),
    "two_and_one_missing": (
        {"k1": ({"t": 0.5}, {}), "k4": ({"u": 0.2}, {}),
         "k2": ({"v": 0.1}, {})},
        {"k1": ({"t": 0.55}, {}), "k4": ({"u": 0.9}, {})}, []),
}


@pytest.mark.parametrize("files", [False, True], ids=["dirs", "files"])
@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_compare_main_exits_as_the_reference(tmp_path, capsys, envs, case,
                                             files):
    """The same numbers through each package's own files: the same exit
    code and the same lines (paths aside)."""
    old, new, flags = CLI_CASES[case]
    out = {}
    for key, (schema, _, _, cmp) in PACKAGES.items():
        root = tmp_path / key
        _write_side(root, schema, envs[key], old, new)
        args = [str(root / "old"), str(root / "new")]
        if files:
            args = [os.path.join(a, schema.result_filename("k1"))
                    for a in args]
        rc = cmp.main(args + flags)
        lines = capsys.readouterr().out.replace(str(root), "<root>")
        out[key] = (rc, lines.splitlines())
    assert out["port"] == out["ref"]
    assert out["port"][0] in (0, 1)


def test_compare_refusals_match_the_reference(tmp_path, envs):
    for key, (schema, _, _, cmp) in PACKAGES.items():
        root = tmp_path / key
        _write_side(root, schema, envs[key], {"k1": ({"t": 1.0}, {})},
                    {"k1": ({"t": 1.0}, {})})
        with pytest.raises(SystemExit, match="both paths must be files"):
            cmp._pair_paths(str(root / "old"),
                            str(root / "new" / "BENCH_k1.json"))
        (root / "empty").mkdir()
        with pytest.raises(SystemExit, match="no matching BENCH"):
            cmp._pair_paths(str(root / "empty"), str(root / "new"))
        assert cmp._pair_paths(str(root / "old"), str(root / "new")) == [
            (str(root / "old" / "BENCH_k1.json"),
             str(root / "new" / "BENCH_k1.json"))]


def test_compare_warns_where_the_power_limit_differs(tmp_path, capsys,
                                                     envs):
    """Two H100 results at different power limits: the device warning."""
    env = envs["port"]
    for side, limit in (("old", "700.00 W"), ("new", "500.00 W")):
        e = dataclasses.replace(env, device_kind="NVIDIA H100 80GB HBM3",
                                power_limit=limit)
        _result(t_schema, e, name="k1", timings={"t": 1.0}).write(
            str(tmp_path / side))
    assert t_compare.main([str(tmp_path / "old"), str(tmp_path / "new")]) == 0
    warn = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("# warning: device")]
    assert len(warn) == 1 and "700.00 W" in warn[0] and "500.00 W" in warn[0]


# -- registry ----------------------------------------------------------------

def _spec_a(ctx):
    return {}


def _spec_b(ctx):
    """Second toy spec."""
    return {}


def test_registry_errors_match_the_reference(empty_registries):
    errors = {}
    for key, (_, reg, _, _) in PACKAGES.items():
        got = []
        reg.benchmark("toy")(_spec_a)
        reg.benchmark("toy")(_spec_a)            # the same function: idempotent
        with pytest.raises(ValueError) as e:
            reg.benchmark("toy")(_spec_b)
        got.append(str(e.value))
        with pytest.raises(KeyError) as e:
            reg.get("nope")
        got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            reg.BenchContext(tier="huge")
        got.append(str(e.value))
        reg.benchmark("described", figures="Fig 3")(_spec_b)
        got.append((reg.names(), reg.get("described").description,
                    reg.get("described").figures, reg.get("toy").tiers))
        errors[key] = got
    assert errors["port"] == errors["ref"]
    assert t_registry.TIERS == r_registry.TIERS
    assert "already registered" in errors["port"][0]


def test_the_port_registers_no_workload(empty_registries):
    assert t_registry.DEFAULT_MODULES == ()
    assert t_registry.load_default_benchmarks() == []
    assert t_run.DEFAULT_TIMEOUT_S == r_run.DEFAULT_TIMEOUT_S


# -- run ---------------------------------------------------------------------

def _ok(ctx):
    return {"params": {"tier": ctx.tier, "seed": ctx.seed},
            "timings_s": {"t": 0.01}, "counters": {"n": 3},
            "rows": [{"x": 1}], "notes": ["fine"]}


def _skipped(ctx):
    return {"status": "skipped", "notes": ["no card"]}


def _fails(ctx):
    raise ValueError("boom")


def _slow(ctx):
    import time
    time.sleep(5.0)
    return {}


def _junk_timings(ctx):
    return {"timings_s": {"t": "fast", "u": True}}


@pytest.mark.parametrize("fn,timeout", [
    (_ok, None), (_skipped, None), (_fails, None), (_slow, 0.3),
    (_junk_timings, None)], ids=["ok", "skipped", "error", "timeout", "junk"])
def test_run_one_statuses_match_the_reference(fn, timeout):
    got = {}
    for key, (_, reg, run, _) in PACKAGES.items():
        spec = reg.BenchSpec(name="toy", fn=fn)
        res = run.run_one(spec, reg.BenchContext(tier="smoke", seed=3),
                          timeout_s=timeout)
        d = res.to_dict()
        got[key] = ({k: v for k, v in d.items()
                     if k not in ("env", "created_utc", "wall_s")},
                    run.schema.validate(d))
    assert got["port"] == got["ref"]
    status = got["port"][0]["status"]
    assert status == {"_ok": "ok", "_skipped": "skipped", "_fails": "error",
                      "_slow": "timeout",
                      "_junk_timings": "ok"}[fn.__name__]


def test_a_spec_that_emits_junk_comes_back_error(tmp_path,
                                                 empty_registries):
    """``run_benchmarks`` marks a result that fails the schema ``error``
    with the reference's ``schema:`` note (the reference's note from its
    own ``run_one`` and ``validate``: its ``run_benchmarks`` would import
    the repo's benchmark modules)."""
    t_registry.benchmark("junk")(_junk_timings)
    t_registry.benchmark("fine")(_ok)
    res = t_run.run_benchmarks(tier="smoke", only=["junk", "fine"],
                               out_dir=str(tmp_path), verbose=False)
    r_res = r_run.run_one(r_registry.BenchSpec("junk", _junk_timings),
                          r_registry.BenchContext(tier="smoke"))
    want = "schema: " + "; ".join(r_schema.validate(r_res.to_dict()))
    assert [r.status for r in res] == ["error", "ok"]
    assert res[0].notes == [want]
    assert "timings_s['t'] is not a number" in want
    on_disk = json.loads((tmp_path / "BENCH_junk.json").read_text())
    assert on_disk["status"] == "error" and on_disk["notes"] == [want]
    t_schema.load(str(tmp_path / "BENCH_fine.json"))
    with pytest.raises(KeyError, match="unknown benchmark"):
        t_run.run_benchmarks(only=["missing"], out_dir=str(tmp_path))


def test_run_main_exit_codes(tmp_path, capsys, empty_registries):
    t_registry.benchmark("fine", tiers=("smoke",))(_ok)
    t_registry.benchmark("bad", tiers=("full",))(_fails)
    assert t_run.main(["--smoke", "--out", str(tmp_path)]) == 0
    assert t_run.main(["--full", "--out", str(tmp_path)]) == 1
    assert "1 FAILED: ['bad']" in capsys.readouterr().out
    assert t_run.main(["--only", "nope", "--out", str(tmp_path)]) == 2
    assert t_run.main(["--list"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in listed] == ["fine", "bad"]


CLI = ("import runpy, sys\n"
       "sys.argv = ['repro_torch.bench.run'] + sys.argv[1:]\n"
       "try:\n"
       "    runpy.run_module('repro_torch.bench.run', run_name='__main__')\n"
       "except SystemExit as e:\n"
       "    rc = e.code\n"
       "assert not [m for m in sys.modules if m == 'jax' "
       "or m.startswith('jax.')], 'jax imported'\n"
       "sys.exit(rc)\n")


@pytest.mark.parametrize("argv", [["--list"], ["--smoke", "--out", "{out}"]],
                         ids=["list", "smoke"])
def test_cli_runs_without_jax(tmp_path, argv):
    """``python -m repro_torch.bench.run`` in a fresh process: exit 0, no
    workload registered, and never an import of jax."""
    args = [a.format(out=tmp_path / "out") for a in argv]
    res = subprocess.run([sys.executable, "-c", CLI, *args],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    if "--smoke" in argv:
        assert "# 0 benchmarks, tier=smoke" in res.stdout


# -- the tracer ----------------------------------------------------------------

@pytest.mark.parametrize("no_spans", [False, True],
                         ids=["none_ahead", "only_markers"])
@pytest.mark.parametrize("kept_from,want", [(32, 0.5), (512, 0.5),
                                            (None, "not measured")])
def test_device_ms_traces_again_while_no_marker_ahead_was_kept(
        monkeypatch, kept_from, want, no_spans):
    """A trace that kept no marker ahead of the calls may have lost some
    of their records, and one that kept markers only ("either side") all
    of them: ``device_ms`` traces again with 4x the markers, and says
    "not measured" where ``MAX_MARKERS`` did not do."""
    from repro_torch.bench import trace
    seen = []

    def fake_trace(fn, host=(), markers=trace.TRACE_MARKERS):
        fn()
        seen.append(markers)
        if kept_from is None or markers < kept_from:
            if no_spans:
                return {"guard": {"markers_kept": {"either side": markers}},
                        "device_time": "none in the trace"}
            kept = 0
        else:
            kept = 3
        return {"guard": {"markers_kept": {"before": kept, "after": markers}},
                "kernels": {"k_kernel<1>(float*)": {"calls": 4,
                                                     "device_ms": 2.0},
                            "other": {"calls": 4, "device_ms": 9.0}}}

    monkeypatch.setattr(trace, "device_trace", fake_trace)
    guards = []
    assert trace.device_ms(lambda: None, 4, "k_kernel", guards) == want
    grown = [32, 128, 512, 2048]
    assert seen == grown[:grown.index(kept_from) + 1 if kept_from else None]
    assert trace.MAX_MARKERS == grown[-1]


# -- the moved bounds, at PERF.md's rows ---------------------------------------

LEAF, LEAF_K = 253_755_392, 2_537_554       # tinyllama's largest leaf


@pytest.mark.parametrize("K,key,want", [
    (4, "int8", 1.51496), (4, "topk", 1.23621),
    (1, "int8", 0.378739), (1, "decode_int8", 0.378739),
    (1, "topk", 0.309051)])
def test_codec_bounds_at_the_leaf_rows(K, key, want):
    got, by = codec_bounds(K, LEAF, LEAF_K)[key]
    assert by == "bytes"
    assert got == pytest.approx(want, rel=5e-6)


def test_tinyllama_prefill_and_state_bytes():
    cfg = get_config("tinyllama-1.1b")
    flops, nbytes = dense_products(cfg, 8 * 512)
    got, by = bound_ms(nbytes, flops, PEAK_FLOPS_BF16)
    assert by == "operations"
    assert got == pytest.approx(8.5682, rel=5e-6)
    assert state_bytes(cfg, 8, 544) == (98_424_832, 0)

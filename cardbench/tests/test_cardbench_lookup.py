"""The harness finds every configuration, traffic mix, generator and metric
reader of BENCHMARK.json by name, and the file keeps to the contract's
shape."""
import cardbench_fixtures  # noqa: F401  (puts the checkout on the path)
import json
import re

import pytest

from cardbench.harness import core

BENCH = core.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found(cfg):
    loaded = core.config(cfg["name"])
    assert cfg["file"] == f"cardbench/configs/{cfg['name']}.json"
    assert loaded["name"] == cfg["name"]
    assert loaded["reduced"] == cfg["reduced"]
    assert NAME.match(cfg["name"]) and all(NAME.match(k)
                                           for k in cfg["reduced"])


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_found(wl):
    assert wl["name"] == f"{wl['config']}.{wl['traffic']}"
    assert core.workload(BENCH, wl["name"]) is wl
    tr = core.traffic(wl["traffic"])
    drv = core.generator(tr["kind"])
    assert callable(drv.run) and callable(drv.control)
    assert set(tr["limits"]) and all(isinstance(v, (int, float))
                                     for v in tr["limits"].values())
    assert wl["chips"] == 1 and len(wl["why"]) <= 200
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    e2e = [m["name"] for m in core.metrics_of(BENCH, wl["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert core.metrics_of(BENCH, wl["name"], True)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert callable(core.reader(m["name"]).read)
    assert m["better"] in ("lower", "higher")
    for w in m.get("workloads", []):
        core.workload(BENCH, w)
    if m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_size():
    with open(core.ROOT / "BENCHMARK.json", "rb") as f:
        assert len(f.read()) <= 64 * 1024
    assert json.dumps(BENCH)

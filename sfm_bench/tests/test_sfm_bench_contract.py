"""BENCHMARK.json keeps to the benchmark's contract, and every cell, metric
and number it names has its file."""

import json
import os
import re

import pytest

from helpers import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["sfm_bench"] and 1 <= bench["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_allowed_characters(bench, key):
    names = [e["name"] for e in bench[key]]
    assert len(names) == len(set(names))
    for e in bench[key]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k])
        for k in e.get("reduced", []):
            assert NAME.match(k)
        texts = [e[k] for k in ("why", "layer") if k in e]
        if key == "configs":
            texts.append(e["source"])
        for t in texts:
            assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_every_cell_and_metric_has_its_files(bench):
    sb = os.path.join(ROOT, "sfm_bench")
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith("sfm_bench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert os.path.isfile(os.path.join(sb, "mixes", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(sb, "limits", f"{w['name']}.json"))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and all(m["bound"] <= 0.25 for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert os.path.isfile(os.path.join(sb, "end_to_end", f"{m['name']}.py"))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert os.path.isfile(os.path.join(sb, "layer_metrics", f"{m['name']}.py"))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        def applies(m):
            return w["name"] in m.get("workloads", [w["name"]])

        e2e = [m["name"] for m in bench["end_to_end"] if applies(m)]
        layers = [m for m in bench["per_layer"] if applies(m)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        assert all(m["moves"] in e2e for m in layers)

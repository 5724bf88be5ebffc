"""BENCHMARK.json against the benchmark's contract: its keys, names, units,
bounds, and every name it gives found as a file."""

import json
import os
import re

import pytest

import _tiny
from perfbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LAYER_WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head",
                "expansion", "_dim", "_rank", "experts_per_token", "channels")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(_tiny.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_command_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    # a full check of 24 cells fits its 43200 s at this run length
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert os.path.getsize(os.path.join(_tiny.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(_tiny.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in conf, k
            assert not any(w in k for w in LAYER_WIDTHS), k
        assert conf["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(_tiny.ROOT, conf["reference"]))
        assert os.path.isfile(os.path.join(manifest.HERE, "engines", conf["engine"] + ".py"))


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert os.path.isfile(os.path.join(manifest.HERE, "traffic", w["traffic"] + ".json"))


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    allm = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in allm}) == len(allm)
    assert "setup_s" in e2e and 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in allm:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(manifest.HERE, "metrics", m["name"] + ".py"))
        assert manifest.metric_reader(m["name"]).UNIT == m["unit"]
    for cell in cells:     # every cell: setup_s, another end-to-end metric, a layer metric
        rep = manifest.load_cell(_tiny.ROOT, cell)
        assert "setup_s" in rep.end_to_end and len(rep.end_to_end) >= 2
        assert rep.per_layer

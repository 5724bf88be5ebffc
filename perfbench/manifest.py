"""BENCHMARK.json and the files it names.

Everything of one configuration, traffic mix, engine or metric sits in a
file of its own, found by name:

- a configuration: the `file` its entry in BENCHMARK.json gives
  (perfbench/configs/<name>.json), which names its engine
  (perfbench/engines/<engine>.py) and its plain reference;
- a traffic mix: perfbench/traffic/<traffic>.json;
- a metric, end-to-end or per-layer: perfbench/metrics/<name>.py, a reader
  with UNIT and read(run) -> float | None.

So a cell, a configuration or a metric is added with files and entries,
never by editing a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # metric names this cell reports with --trace 0
    per_layer: list         # metric names this cell reports with --trace 1


def load_module(path: str, name: str):
    """The module at `path`, loaded once a process under `name`."""
    if name in sys.modules and getattr(sys.modules[name], "__file__", None) == path:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = HERE):
    return load_module(os.path.join(bench_dir, "metrics", f"{name}.py"),
                       f"perfbench_metric_{name.replace('.', '_')}")


def engine_module(engine: str, bench_dir: str = HERE):
    return load_module(os.path.join(bench_dir, "engines", f"{engine}.py"),
                       f"perfbench_engine_{engine}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, workload: str) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with its configuration,
    traffic and metric names resolved."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    bench_dir = os.path.dirname(os.path.join(root, conf["file"]))
    bench_dir = os.path.dirname(bench_dir)       # perfbench/configs/x.json -> perfbench
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(name=workload, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m["name"] for m in bench["end_to_end"] if _reports(m, workload)],
                per_layer=[m["name"] for m in bench["per_layer"] if _reports(m, workload)])

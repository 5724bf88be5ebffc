"""A configuration, a traffic mix and a metric added as files, with their
entries in BENCHMARK.json, are found by name with no file edited."""

import hashlib
import json
import os
import shutil

import _tiny
from perfbench import manifest


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha1(open(p, "rb").read()).hexdigest()
    return out


def test_added_files_are_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(_tiny.ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(_tiny.ROOT, "BENCHMARK.json"), root)
    before = _digest(root / "perfbench")
    bench_dir = str(root / "perfbench")

    conf = json.load(open(root / "perfbench/configs/ffhq_p2_f32.json"))
    conf["name"] = "afhq_p2_f32"
    conf["model_name"] = "AFHQ_P2"
    (root / "perfbench/configs/afhq_p2_f32.json").write_text(json.dumps(conf))
    (root / "perfbench/traffic/small_box_edits.json").write_text(json.dumps(
        {"warmup": 1, "mask_cover": [0.05, 0.1]}))
    (root / "perfbench/metrics/invert_s.py").write_text(
        'UNIT = "s"\n\n\ndef read(run):\n    return 1.25\n')
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["configs"].append({"name": "afhq_p2_f32", "source": "https://example.org/afhq",
                             "file": "perfbench/configs/afhq_p2_f32.json",
                             "reduced": conf["reduced"], "why": "another face model"})
    bench["workloads"].append({"name": "afhq_small", "config": "afhq_p2_f32",
                               "traffic": "small_box_edits", "chips": 1, "why": "small masks"})
    bench["per_layer"].append({"name": "invert_s", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "Sampling",
                               "moves": "edit_s", "workloads": ["afhq_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.load_cell(str(root), "afhq_small")
    assert cell.config["model_name"] == "AFHQ_P2"
    assert cell.traffic["mask_cover"] == [0.05, 0.1]
    assert "invert_s" in cell.per_layer and "edit_s" in cell.end_to_end
    assert manifest.metric_reader("invert_s", bench_dir).read(None) == 1.25
    assert manifest.engine_module(cell.config["engine"], bench_dir).Engine
    old = manifest.load_cell(str(root), "p2_edit")
    assert "invert_s" not in old.per_layer
    after = _digest(root / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before

"""The comparison that decides `correct`, end to end at a test's size on
the CPU (the harness's look for a card skipped): a sound run is correct,
and the control (the plain reference computed with its products' operands
rounded to TF32, put in the program's place) is not, under the cell
configurations' limits."""

import pytest
import torch

import _tiny
from perfbench import harness, manifest
from perfbench.reference import loco


def _run(cell, seed, control, monkeypatch, tmp_path):
    torch.set_num_threads(2)
    eng = manifest.engine_module(cell.config["engine"]).Engine
    if control:
        judge = eng.judge
        monkeypatch.setattr(eng, "judge", lambda self, recs: judge(
            self, recs, quant=loco.tf32_round))
    return harness.run_cell(cell, seed, 0, False, "cpu", workdir=str(tmp_path))


@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_p2_edit(control, monkeypatch, tmp_path):
    out = _run(_tiny.p2_cell("fp32"), 5, control, monkeypatch, tmp_path)
    assert out["correct"] is (not control), out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_lcm_edit(control, monkeypatch, tmp_path):
    monkeypatch.setenv("LOCO_SD_PRESET", "tiny")
    out = _run(_tiny.lcm_cell("fp32"), 6, control, monkeypatch, tmp_path)
    assert out["correct"] is (not control), out["checks"]


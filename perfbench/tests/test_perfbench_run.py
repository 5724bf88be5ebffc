"""run.py as a checkout runs it: no result without a card, none in a
directory that holds only the benchmark, and (on a card) one result line
with the contract's keys."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import _tiny

CMD = ["perfbench/run.py", "--workload", "p2_edit", "--seed", "3000000007",
       "--seconds", "1", "--trace", "0"]


def _run(cwd, timeout=900):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *CMD], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()


def test_no_card_no_result():
    if _has_card():
        pytest.skip("a card is present: this checks the run without one")
    r = _run(_tiny.ROOT, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA card" in r.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copytree(os.path.join(_tiny.ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(_tiny.ROOT, "BENCHMARK.json"), tmp_path)
    r = _run(str(tmp_path), timeout=600)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
def test_one_run_on_the_card():
    if not _has_card():
        pytest.skip("needs an NVIDIA card")
    r = _run(_tiny.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"edit_s", "setup_s"}
    assert list(out)[-1] == "checks"

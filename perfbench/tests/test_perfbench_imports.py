"""No module of the JAX side in a run, and a reference that imports
nothing of the program: read from the sources, and the run-time check."""

import ast
import glob
import os
import sys

import _tiny
from perfbench import harness

BENCH = os.path.join(_tiny.ROOT, "perfbench")
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "loco_edit_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_the_jax_side():
    files = glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
    assert len(files) > 20
    for path in files:
        assert not set(_imports(path)) & JAX_SIDE, path


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert {os.path.basename(f) for f in files} >= {"adm.py", "sd.py", "loco.py", "lcm.py"}
    for path in files:
        mods = set(_imports(path))
        assert "loco_edit_tpu_torch" not in mods, path
        assert mods <= {"__future__", "dataclasses", "hashlib", "math", "numpy", "torch",
                        "perfbench"}, (path, mods)


def test_the_run_time_check_compares_whole_top_level_names(monkeypatch):
    fake = dict(sys.modules)
    fake["loco_edit_tpu_torch.serve"] = object()
    fake["loco_edit_tpu_torchx"] = object()
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    fake["loco_edit_tpu.models"] = object()
    fake["jaxlib"] = object()
    assert harness.forbidden_modules() == ["jaxlib", "loco_edit_tpu.models"]


def test_a_tiny_run_loads_nothing_of_the_jax_side():
    import subprocess

    code = ("import sys; sys.path.insert(0, 'perfbench/tests'); import _tiny, torch; "
            "torch.set_num_threads(2); from perfbench import harness; "
            "out = harness.run_cell(_tiny.p2_cell(), 3, 0, False, 'cpu'); "
            "print(out['correct'], harness.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=_tiny.ROOT, capture_output=True,
                       text=True, timeout=600, env={**os.environ, "PYTHONPATH": _tiny.ROOT})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "True []"

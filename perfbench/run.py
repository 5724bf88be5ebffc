"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The program under test is the PyTorch port,
`loco_edit_tpu_torch`, on one NVIDIA card; there is no CPU fallback. The
last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and the compared
numbers with their limits under "checks"); the compared numbers are also
the last lines of standard error. The program's kernel builds are kept in
.perfbench_cache/ inside the checkout, so only a checkout's first run
builds.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("perfbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["LOCO_COMPILE_CACHE"] = os.path.join(cache, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)

    from perfbench import harness, manifest

    cell = manifest.load_cell(ROOT, a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", T_START)
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: modules of the JAX side are loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

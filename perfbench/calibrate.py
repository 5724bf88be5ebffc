"""The readings the limits of `correct` are set from, at a cell's own size.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n,...> \
        [--control <n,...>] [--seconds 0]

runs the cell once for each seed in one process, each run as run.py runs
it (its own weights, server, traffic, window and judgement), but without
the mix's warm-up requests: they only warm the timing, and the program
picks its kernels' algorithms by heuristics, not by timing, so the first
edit computes what a later one does. --seconds 0 makes the window one
request. Per seed it prints the numbers the comparison gives for the
program and, for the --control seeds, for the control: the plain
reference with every product's operands rounded to TF32
(reference/loco.py::tf32_round), the precision below the configurations'
float32 with TF32 off, standing in for the program. The control is judged
by the limit test a run applies (harness.within_limits), and its
`control.correct` has to come out false. The lower reading of a limit is
the largest program reading over the seeds, the upper the smallest
control reading. Benchmark runs never run the control. One JSON line per
seed, and a summary line last.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("perfbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated run seeds")
    p.add_argument("--control", default="", help="seeds that also run the control")
    p.add_argument("--seconds", type=float, default=0.0)
    a = p.parse_args(argv)
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["LOCO_COMPILE_CACHE"] = os.path.join(cache, "build")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)

    from perfbench import harness, inputs, manifest
    from perfbench.reference import loco

    cell = manifest.load_cell(ROOT, a.workload)
    cell.traffic = dict(cell.traffic, warmup=0)
    limits = cell.config["check"]["limits"]
    engine_cls = manifest.engine_module(cell.config["engine"]).Engine
    control_weights = {inputs.sub_seed(int(s), "weights") for s in a.control.split(",") if s}
    seen = []
    judge = engine_cls.judge

    def judge_both(self, records):
        t0 = time.perf_counter()
        out = judge(self, records)
        out["judge_s"] = time.perf_counter() - t0
        if self.weight_seed in control_weights:
            t0 = time.perf_counter()
            ctl = judge(self, records, quant=loco.tf32_round)
            out.update({f"control.{k}": v for k, v in ctl.items()})
            out["control.correct"] = harness.within_limits(ctl, limits)
            out["control_s"] = time.perf_counter() - t0
        seen.append(out)
        return out

    engine_cls.judge = judge_both
    rows = []
    for s in (int(x) for x in a.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(cell, s, a.seconds, False, "cuda")
        rec = out["metrics"]
        row = {"seed": s, "correct": out["correct"], "run_s": time.perf_counter() - t0,
               "edit_s": rec.get("edit_s", {}).get("value"), **seen[-1]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for k in rows[0]:
        if k.startswith("control.") or k in limits:
            vals = [r[k] for r in rows if k in r]
            summary[k] = {"min": min(vals), "max": max(vals), "n": len(vals)}
    print(json.dumps({"summary": summary, "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

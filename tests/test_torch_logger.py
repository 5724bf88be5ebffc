"""The port's observability and eval entry points on the CPU: the Logger's
files against the JAX package's for one key-value sequence, device_trace
with the program's spans in it, the CLI's --trace_dir run, and the parity_eval
dry run (TinyTest, Random, a box mask) with the JAX package's report
fields."""

import json
import os

import numpy as np
import torch

torch.set_num_threads(2)

TINY = ["--model_name", "TinyTest", "--dataset_name", "Random", "--for_steps", "6",
        "--inv_steps", "6", "--edit_t", "0.6", "--performance_boosting_t", "0.2",
        "--x_space_guidance_scale", "0.5", "--x_space_guidance_num_step", "2",
        "--pca_rank", "1", "--pca_rank_null", "1", "--vis_num", "1", "--seed", "7",
        "--device", "cpu"]


def _kv_run(logger_cls, log_dir):
    log = logger_cls(log_dir, formats=("stdout", "json", "csv"))
    outs = []
    for step in range(3):
        log.logkv("step", step)
        log.logkv("lr", 1e-4 * (step + 1))
        for v in (0.5, 1.5, 2.5 + step):
            log.logkv_mean("loss", v)
        with log.profile("work"):
            pass
        outs.append(log.dumpkvs())
    log.close()
    return outs


def test_logger_writes_the_jax_files(tmp_path, capsys):
    from loco_edit_tpu.utils.logger import Logger as JaxLogger
    from loco_edit_tpu_torch.utils.logger import Logger

    got = _kv_run(Logger, str(tmp_path / "port"))
    port_out = capsys.readouterr().out
    ref = _kv_run(JaxLogger, str(tmp_path / "jax"))
    jax_out = capsys.readouterr().out
    # profile scopes time wall clock: compare their keys, the rest exactly
    drop = lambda d: {k: v for k, v in d.items() if not k.startswith("time/")}  # noqa: E731
    assert [drop(d) for d in got] == [drop(d) for d in ref]
    assert [sorted(d) for d in got] == [sorted(d) for d in ref]
    for name in ("progress.jsonl", "progress.csv"):
        mine = open(tmp_path / "port" / name).read().splitlines()
        theirs = open(tmp_path / "jax" / name).read().splitlines()
        assert len(mine) == len(theirs) == (3 if name.endswith("jsonl") else 4)
        if name.endswith("jsonl"):
            assert [drop(json.loads(a)) for a in mine] == [drop(json.loads(b)) for b in theirs]
        else:
            assert mine[0] == theirs[0] == "loss,lr,step,time/work"
            assert [r.split(",")[:3] for r in mine[1:]] == [r.split(",")[:3] for r in theirs[1:]]
    table = [ln for ln in port_out.splitlines() if "time/" not in ln]
    assert table == [ln for ln in jax_out.splitlines() if "time/" not in ln]


def test_device_trace_on_the_cpu(tmp_path):
    """A Chrome trace of the enclosed CPU work: its window annotation, and
    the program's spans on a track of their own, on the trace's time base:
    each encloses the aten:: ops run inside it (to 0.2 ms, the clocks'
    agreement in tests/test_torch_spans.py)."""
    from loco_edit_tpu_torch.utils.logger import TRACE_WINDOW, device_trace, recording, span

    with device_trace(str(tmp_path / "tr"), cuda=False):
        with span("outer"):
            a = torch.randn(64, 64)
            with span("inner"):
                (a @ a).relu().sum()
    assert not recording()
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    (window,) = [e for e in events if e.get("name") == TRACE_WINDOW]
    spans = {e["name"]: e for e in events if e.get("cat") == "loco_span"}
    assert set(spans) == {"outer", "inner"}
    tracks = {e["pid"]: e["args"]["name"] for e in events
              if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert tracks[spans["outer"]["pid"]] == "loco spans"
    assert spans["inner"]["args"]["parent"] == spans["outer"]["args"]["id"]

    def within(e, s, slack_us=200.0):
        return (s["ts"] - slack_us <= e["ts"]
                and e["ts"] + e["dur"] <= s["ts"] + s["dur"] + slack_us)

    ops = {n: [e for e in events if e.get("name") == n] for n in ("aten::randn", "aten::mm")}
    assert ops["aten::randn"] and ops["aten::mm"]
    assert all(within(e, spans["outer"]) for e in ops["aten::randn"])
    assert all(within(e, spans["inner"]) for e in ops["aten::mm"])
    assert within(spans["outer"], window)


def test_cli_trace_dir_run(tmp_path):
    """--trace_dir wraps the whole CLI run (here a TinyTest edit on the CPU)
    in device_trace; the edit's result is returned as without it."""
    from loco_edit_tpu_torch.cli import main

    out = main.main(TINY + ["--use_mask", "false", "--run_edit_null_space_projection",
                            "true", "--result_folder", str(tmp_path / "runs"),
                            "--trace_dir", str(tmp_path / "trace")])
    assert sorted(out["edit"]["strips"]) == [0]
    events = json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "aten::convolution" for e in events)


def test_parity_eval_dry_run_matches_jax_fields(tmp_path):
    """The parity_eval dry run (the JAX package's own test settings): one
    record with the JAX harness's keys, its metrics in range, the JSONL
    written; _metrics of both packages on one edited/original/mask triple
    equal to 1e-6."""
    from loco_edit_tpu.cli.parity_eval import _metrics as jax_metrics
    from loco_edit_tpu_torch.cli.parity_eval import _metrics, main

    recs = main(["--model_name", "TinyTest", "--dataset_name", "Random",
                 "--sample_specs", "0:hair", "--for_steps", "8", "--pca_rank", "1",
                 "--pca_rank_null", "1", "--x_space_guidance_num_step", "4",
                 "--result_folder", str(tmp_path), "--seed", "3", "--device", "cpu"])
    assert len(recs) == 1
    r = recs[0]
    assert set(r) == {"sample_idx", "semantic", "ssim", "offmask_mse", "inmask_mse"}
    assert 0.0 <= r["ssim"] <= 1.0 and r["offmask_mse"] >= 0.0 and r["inmask_mse"] >= 0.0
    with open(os.path.join(tmp_path, "parity_metrics.jsonl")) as f:
        assert json.loads(f.read()) == r
    rng = np.random.default_rng(4)
    e, o = (rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32) for _ in range(2))
    mask = np.zeros((1, 32, 32, 3), bool)
    mask[:, 8:16, 8:16] = True
    got, ref = _metrics(e, o, mask, "cpu"), jax_metrics(e, o, mask)
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k

"""The if_edit cell: its configuration, traffic and metrics found by name,
the IF engine's operation count, the new readers on a hand-made run, and a
tiny IF cascade cell run through the harness on the CPU (correct, its TF32
control not, and a program that serves other geometry refused at set-up)."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _tiny
from perfbench import flops, harness, manifest, spans, trace, traffic
from perfbench.harness import Record, Run
from perfbench.reference import ifm, loco

from loco_edit_tpu_torch.utils.logger import SpanRecord

NEW = ("superres_s", "superres_idle", "superres_mfu", "sr_forwards", "cascade_mfu")
MS = 1_000_000


def _full():
    return _tiny._load("configs/deepfloyd_if_m_iil_f32.json")


def _engine(config):
    return manifest.engine_module("deepfloyd").Engine(config, device="cpu", weight_seed=1,
                                                      server_seed=1, prompt_seed=1)


def test_the_cell_is_found_by_name():
    cell = manifest.load_cell(_tiny.ROOT, "if_edit")
    assert (cell.config_name, cell.traffic_name, cell.chips) == (
        "deepfloyd_if_m_iil_f32", "if_prompt_edits", 1)
    assert cell.end_to_end == ["edit_s", "setup_s"] and cell.per_layer == list(NEW)
    assert cell.config["engine"] == "deepfloyd"
    assert (cell.config["stage1"]["parameters"], cell.config["stage2"]["parameters"]) == (
        426_944_518, 1_170_580_998)
    for other in ("p2_edit", "lcm_edit"):
        assert not set(NEW) & set(manifest.load_cell(_tiny.ROOT, other).per_layer)
    warm, window = traffic.requests(cell.traffic, 2**40 + 3, (64, 64))
    reqs = warm + [next(window) for _ in range(20)]
    assert len(warm) == 1
    assert {r["for_prompt"] for r in reqs} == {"A photo of a man",
                                              "A photo of a man wearing glasses"}
    for r in reqs:
        y0, y1, x0, x1 = r["mask_bbox"]
        assert 0 <= y0 < y1 <= 64 and 0 <= x0 < x1 <= 64 and r["semantic"] is False
        assert 0.05 < (y1 - y0) * (x1 - x0) / 64**2 < 0.55


def test_the_edits_operations():
    """Per edit: 24 CFG generation steps and 3 x 75 strip steps of IF-I-M,
    a 10-sweep basis over 5 + 5 probes of the CFG pair, and 3 x 49 CFG
    updates of IF-II-L at 256 px; each forward counted on the reference."""
    cfg = _full()
    eng = _engine(cfg)
    u1, u2 = ifm.build(cfg, "meta")
    with torch.device("meta"):
        ctx = torch.empty(1, 77, 4096)
        f1 = flops.forward_flops(u1, torch.empty(1, 64, 64, 3), 500.0, ctx)
        f2 = flops.forward_flops(u2, torch.empty(1, 256, 256, 6), 500.0, ctx, 250.0)
    assert f1 == pytest.approx(156.6e9, rel=1e-3) and f2 == pytest.approx(6807.8e9, rel=1e-3)
    assert (eng.t_idx, len(eng.grid)) == (24, 99) and list(eng.offsets) == [-12.8, 0, 12.8]
    up = 2 * 3 * 49 * f2
    assert eng.flops.superres == up
    assert eng.flops == 2 * f1 * (24 + 3 * 75) + flops.basis_flops(2 * f1, 10, 10) + up
    assert float(eng.flops) == pytest.approx(2.142e15, rel=1e-3)


@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
def test_the_reference_counts_what_flop_counter_counts_on_the_programs_model(stage2):
    from loco_edit_tpu_torch.models.ifm import IFUNet, tiny_if_config

    cfg = tiny_if_config(stage2=stage2)
    sizes = dataclasses.asdict(cfg)
    s, c = cfg.sample_size, cfg.in_channels
    with torch.device("meta"):
        ours = flops.forward_flops(ifm.UNet(sizes), torch.empty(1, s, s, c), 500.0,
                                   torch.empty(1, 77, 48), 250.0)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        IFUNet(cfg).eval()(torch.randn(1, s, s, c), 500.0, torch.randn(1, 77, 48),
                           250.0 if stage2 else None)
    assert ours == fc.get_total_flops() > 0


class Rec:
    def __init__(self, spans, counts):
        self.spans, self.counts = spans, counts


def _span(name, sid, parent, req, t0, t1):
    return SpanRecord(name, sid, parent, req, 1, t0 * MS, t1 * MS)


def test_the_readers_on_a_hand_made_run():
    """A warm-up request and two window requests over 0-100 ms, the device
    busy in 10-30 and 50-90; each edit's upscale (superres span) 20-40 and
    70-95 ms, 6 PFLOP of which 2 in the upscale."""
    Ops = manifest.engine_module("deepfloyd").Ops
    s = [_span("request", 1, None, 1, -50, -10), _span("superres", 2, 1, 1, -40, -20)]
    for rid, t0, t1 in ((10, 20, 40), (20, 70, 95)):
        s += [_span("request", rid, None, rid, t0 - 20, t1 + 5),
              _span("superres", rid + 1, rid, rid, t0, t1)]
    t = trace.Trace(window_s=0.1, busy_s=0.06)
    t.window_ns, t.busy = (0, 100 * MS), [(10 * MS, 30 * MS), (50 * MS, 90 * MS)]
    recs = [Record(request={}, client_s=1.0, timings={"superres": v}, flops=Ops(6e15, 2e15))
            for v in (2.0, 3.0)]
    run = Run(records=recs, window_s=0.1, setup_s=9.0, peak_bytes=0, peak_flops=495e12,
              trace=t)
    counts = {1: {"sr_forwards": 49}, 10: {"sr_forwards": 49}, 20: {"sr_forwards": 47}}
    spans._state.update(armed=True, run=run, recording=Rec(s, counts))
    try:
        read = {n: manifest.metric_reader(n).read(run) for n in NEW}
    finally:
        spans._state.update(armed=False, run=None, recording=None)
    assert read["superres_s"] == pytest.approx(2.5)
    # 20-40 (busy 20-30) and 70-95 (busy 70-90): idle 15 of 45 ms
    assert read["superres_idle"] == pytest.approx(100 * 15 / 45)
    assert read["superres_mfu"] == pytest.approx(100 * 4e15 / (0.045 * 495e12))
    assert read["sr_forwards"] == pytest.approx(48.0)
    assert read["cascade_mfu"] == pytest.approx(100 * 12e15 / (0.1 * 495e12))
    assert read["cascade_mfu"] == manifest.metric_reader("mfu").read(run)


def test_a_program_without_them_reads_nothing():
    """A run with nothing of stage 2 to read (no superres timings, no
    recorder, plain float operation counts): the stage-2 readers read
    nothing, and cascade_mfu reads what mfu reads."""
    spans._state.update(armed=False, run=None, recording=None)
    run = Run(records=[Record(request={}, client_s=1.0, flops=1e12)], window_s=1.0,
              setup_s=2.0, peak_bytes=0, peak_flops=495e12,
              trace=trace.Trace(window_s=1.0, busy_s=0.5))
    got = {n: manifest.metric_reader(n).read(run) for n in NEW}
    assert got == {"superres_s": None, "superres_idle": None, "superres_mfu": None,
                   "sr_forwards": None, "cascade_mfu": pytest.approx(100 * 1e12 / 495e12)}


def _tiny_cell() -> manifest.Cell:
    """The if_edit cell over the tiny IF cascade (the caller sets
    LOCO_IF_PRESET "tiny,tiny": 16 px stage 1, 32 px stage 2), 10 steps,
    2 sweeps, rank 2 + null 2, guidance 3; the upscaler's 50 steps."""
    from loco_edit_tpu_torch.models.ifm import IFUNet, tiny_if_config

    cfg = _full()
    for key, stage2 in (("stage1", False), ("stage2", True)):
        c = tiny_if_config(stage2=stage2)
        cfg[key] = {k: v for k, v in dataclasses.asdict(c).items() if k != "dtype"}
        cfg[key]["parameters"] = sum(p.numel() for p in IFUNet(c).parameters())
    cfg["edit"].update(for_steps=10, sweeps=2, pca_rank=2, pca_rank_null=2,
                       guidance_scale=3.0, x_space_guidance_scale=1.0,
                       x_space_guidance_num_step=4)
    return manifest.Cell("tiny_if", "tiny_if", "if_prompt_edits", 1, cfg,
                         _tiny._load("traffic/if_prompt_edits.json"), ["edit_s", "setup_s"],
                         [])


@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_a_tiny_cascade_is_judged(control, monkeypatch, tmp_path):
    torch.set_num_threads(2)
    monkeypatch.setenv("LOCO_IF_PRESET", "tiny,tiny")
    cell = _tiny_cell()
    eng = manifest.engine_module("deepfloyd").Engine
    if control:
        judge = eng.judge
        monkeypatch.setattr(eng, "judge", lambda self, recs: judge(
            self, recs, quant=loco.tf32_round))
    out = harness.run_cell(cell, 2**33 + 5, 0, False, "cpu", workdir=str(tmp_path))
    assert out["correct"] is (not control), out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    if not control:
        assert out["checks"]["strips_gap"]["value"] < 1e-3
        assert out["checks"]["basis_gap"]["value"] < 1e-10


def test_other_geometry_is_refused_before_the_warm_up(monkeypatch, tmp_path):
    """A program that serves the tiny stage 1 alone (as the bundle did
    without files before IF-I-M + IF-II-L were its default) fails at the
    engine's parameter check, before any request."""
    monkeypatch.setenv("LOCO_IF_PRESET", "tiny")
    cell = _tiny_cell()
    posted = []
    monkeypatch.setattr(harness, "post", lambda *a: posted.append(a))
    with pytest.raises(ValueError, match="served stage2 U-Net has 0 parameters"):
        harness.run_cell(cell, 7, 0, False, "cpu", workdir=str(tmp_path))
    assert posted == []

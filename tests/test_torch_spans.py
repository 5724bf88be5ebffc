"""The port's program spans (utils/logger.py) on the CPU: a served TinyTest
edit with the recorder off and on (the span tree under one request, the
phase timings from the spans' own clock reads, one sweep span a pass of the
subspace iteration, the readback counter), and the spans' clock against
torch.profiler's."""

import json
import threading
import urllib.request

import pytest
import torch

from loco_edit_tpu_torch.utils import logger

torch.set_num_threads(2)

ARGV = ["--model_name", "TinyTest", "--dataset_name", "Random", "--for_steps", "6",
        "--inv_steps", "6", "--edit_t", "0.6", "--performance_boosting_t", "0.2",
        "--x_space_guidance_scale", "0.5", "--x_space_guidance_num_step", "2",
        "--pca_rank", "1", "--pca_rank_null", "2", "--vis_num", "1",
        "--null_space_projection", "true", "--seed", "5", "--device", "cpu"]
PHASES = {"invert", "generate", "basis", "strips", "io"}
REQ = {"seed": 3, "mask_bbox": [4, 20, 6, 22]}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's TinyTest EditService over HTTP on port 0 (2-3 sweeps a
    basis, so the convergence read runs), with its bases' iteration counts
    and _host calls counted."""
    from loco_edit_tpu_torch.cli.args import parse_args, preset
    from loco_edit_tpu_torch.pipelines import common, uncond
    from loco_edit_tpu_torch.serve import EditService, make_server

    args = preset(parse_args(ARGV + ["--result_folder",
                                     str(tmp_path_factory.mktemp("spans"))]))
    svc = EditService(args)
    svc.pipe.cfg.min_iter, svc.pipe.cfg.max_iter = 1, 3
    svc.pipe.cfg.convergence_threshold = 0.0
    seen = {"iters": [], "host": 0}
    mp = pytest.MonkeyPatch()

    def counted_host(t, _orig=common._host):
        seen["host"] += 1
        return _orig(t)

    def iters_of(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            seen["iters"] += [b.iters for b in (out if isinstance(out, tuple) else (out,))]
            return out
        return run

    for mod in (common, uncond):
        mp.setattr(mod, "_host", counted_host)
    mp.setattr(uncond, "subspace_iteration", iters_of(uncond.subspace_iteration))
    mp.setattr(uncond, "dual_subspace_iteration", iters_of(uncond.dual_subspace_iteration))
    srv = make_server(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/edit"

    def edit(req):
        seen.update(iters=[], host=0)
        data = json.dumps({**req, "sample_name": f"s{req['seed']}"}).encode()
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=300) as r:
            return json.loads(r.read())

    yield svc, edit, seen
    srv.shutdown()
    srv.server_close()
    mp.undo()


def test_recorder_off_records_nothing(served):
    svc, edit, _ = served
    assert not logger.recording()
    assert logger.span("sweep") is logger.span("request")      # the shared null
    out = edit({**REQ, "seed": 1})
    assert set(svc.pipe.timings) == PHASES and out["secs"] > 0
    assert logger._REC is None
    assert logger.stop_recording().spans == []


def test_spans_of_a_served_edit(served):
    svc, edit, seen = served
    logger.start_recording()
    try:
        out = edit(REQ)
    finally:
        rec = logger.stop_recording()
    by_id = {s.id: s for s in rec.spans}
    (root,) = [s for s in rec.spans if s.name == logger.REQUEST]
    (ed,) = [s for s in rec.spans if s.name == "request.edit"]
    assert root.parent is None and root.attrs == {"route": "/edit"}
    assert ed.parent == root.id and ed.request == root.id
    assert round(ed.seconds, 3) == out["secs"]
    phases = [s for s in rec.spans if s.name in PHASES]
    assert {s.name for s in phases} == PHASES
    for s in phases:
        assert s.parent == ed.id and s.request == root.id
        assert ed.t0_ns <= s.t0_ns <= s.t1_ns <= ed.t1_ns
    assert all(s.request == root.id for s in rec.spans)
    for name in PHASES:
        assert svc.pipe.timings[name] == sum(s.seconds for s in phases if s.name == name)
    sweeps = [s for s in rec.spans if s.name == "sweep"]
    assert seen["iters"] == [3, 3] and len(sweeps) == sum(seen["iters"])
    assert all(by_id[s.parent].name == "basis" and s.device_ms is None for s in sweeps)
    reads = [s for s in rec.spans if s.name == "readback"]
    assert rec.counts[root.id]["readbacks"] == len(reads) >= seen["host"] > 0
    # the eigh of every sweep and each basis's convergence read are readbacks too
    assert len(reads) >= seen["host"] + len(sweeps) + 2


def test_a_span_shares_the_profilers_clock():
    """A span around a record_function on the same thread encloses the
    profiler's event to within 0.2 ms at each end."""
    from torch.profiler import ProfilerActivity, profile, record_function

    logger.start_recording()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with logger.span("outer"):
                    with record_function("inner"):
                        a = torch.randn(128, 128)
                        (a @ a).sum()
    finally:
        rec = logger.stop_recording()
    inner = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events() if e.name() == "inner")
    outer = sorted((s.t0_ns, s.t1_ns) for s in rec.spans)
    assert len(inner) == len(outer) == 3
    for (e0, e1), (s0, s1) in zip(inner, outer):
        assert s0 - 200_000 <= e0 <= e1 <= s1 + 200_000

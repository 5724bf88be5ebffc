"""The readers of program spans on synthetic device intervals and spans,
the wrapped trace reduction against the plain one, and a tiny traced run
on the CPU that reports them."""

import pytest

import _tiny
from perfbench import harness, manifest, spans, trace
from perfbench.harness import Record, Run
from perfbench.trace import WINDOW, Event
from test_perfbench_trace import _events, _run

from loco_edit_tpu_torch.utils.logger import SpanRecord

MS = 1_000_000
NEW = ("generate_idle", "basis_idle", "strips_idle", "sweep_ms", "readbacks", "cold_edit_s")
OLD = ("edit_s", "setup_s", "server_ms", "basis_s", "forwards", "mfu", "idle_share",
       "peak_mem_gib", "io_s", "gn_roofline", "attn_roofline", "generate_s", "strips_s")


class Rec:
    """A Recording's two fields."""

    def __init__(self, spans, counts):
        self.spans, self.counts = spans, counts


def _span(name, sid, parent, req, t0, t1, device_ms=None):
    return SpanRecord(name, sid, parent, req, 1, t0 * MS, t1 * MS, device_ms)


def _recorded():
    """A warm-up request (id 1) and two window requests (ids 10 and 20)
    over a window of 0-100 ms whose device is busy in 10-30 and 50-90."""
    s = [_span("request", 1, None, 1, -50, -10), _span("request.edit", 2, 1, 1, -48, -12),
         _span("basis", 3, 2, 1, -40, -20), _span("sweep", 4, 3, 1, -40, -30, 9.0)]
    for rid, t in ((10, 0), (20, 50)):
        s += [_span("request", rid, None, rid, t, t + 50),
              _span("request.edit", rid + 1, rid, rid, t + 1, t + 49),
              _span("generate", rid + 2, rid + 1, rid, t + 1, t + 11),
              _span("basis", rid + 3, rid + 1, rid, t + 11, t + 41),
              _span("sweep", rid + 4, rid + 3, rid, t + 11, t + 21, 4.0 + rid / 10),
              _span("readback", rid + 5, rid + 3, rid, t + 21, t + 22),
              _span("sweep", rid + 6, rid + 3, rid, t + 22, t + 32, 6.0),
              _span("strips", rid + 7, rid + 1, rid, t + 41, t + 49)]
    return Rec(s, {1: {"readbacks": 7}, 10: {"readbacks": 3}, 20: {"readbacks": 5}})


def _synthetic_run():
    busy = [(10 * MS, 30 * MS), (50 * MS, 90 * MS)]
    t = trace.Trace(window_s=0.1, busy_s=0.06)
    t.window_ns, t.busy = (0, 100 * MS), busy
    recs = [Record(request={}, client_s=1.0) for _ in range(2)]
    run = Run(records=recs, window_s=0.1, setup_s=9.0, peak_bytes=0, trace=t)
    spans._state.update(armed=True, run=run, recording=_recorded())
    return run


def test_readers_of_program_spans_are_exact():
    run = _synthetic_run()
    try:
        read = {n: manifest.metric_reader(n).read(run) for n in NEW}
    finally:
        spans._state.update(armed=False, run=None, recording=None)
    # generate: 1-11 (busy 10-11) and 51-61 (busy all): idle 9 of 20 ms
    assert read["generate_idle"] == pytest.approx(100 * 9 / 20)
    # basis: 11-41 (busy 11-30: 19) and 61-91 (busy 61-90: 29): idle 12 of 60
    assert read["basis_idle"] == pytest.approx(100 * 12 / 60)
    # strips: 41-49 (none busy) and 91-99 (none): all idle
    assert read["strips_idle"] == pytest.approx(100.0)
    # the window's four sweeps (the warm-up's 9 ms left out)
    assert read["sweep_ms"] == pytest.approx((5.0 + 6.0 + 6.0 + 6.0) / 4)
    assert read["readbacks"] == pytest.approx(4.0)
    assert read["cold_edit_s"] == pytest.approx(0.036)


def test_idle_by_span_names_each_gap_by_its_innermost_open_span():
    rec = _recorded()
    busy = [(10 * MS, 30 * MS), (50 * MS, 90 * MS)]
    got = dict(spans.idle_by_span(rec.spans, (0, 100 * MS), busy))
    # gaps 0-10 (opens in request 10 before its edit), 30-50 (opens in its
    # second sweep, 22-32), 90-100 (opens in request 20's basis, 61-91)
    assert got == {"request": pytest.approx(0.010), "sweep": pytest.approx(0.020),
                   "basis": pytest.approx(0.010)}
    assert spans.idle_by_span([], (0, 100 * MS), busy) == [("none", pytest.approx(0.04))]
    assert spans.idle_by_span(rec.spans, (0, 100 * MS), busy, top=1) == [
        ("sweep", pytest.approx(0.020))]


def test_busy_within_counts_only_the_overlap():
    busy = [(10, 30), (50, 90)]
    assert spans.busy_within(busy, 0, 100) == 60
    assert spans.busy_within(busy, 20, 60) == 20
    assert spans.busy_within(busy, 30, 50) == 0
    assert spans.busy_within(busy, 55, 56) == 1
    assert spans.busy_within([], 0, 5) == 0


def test_the_wrapped_reduction_keeps_every_value_and_adds_the_busy_intervals():
    wrapped = trace.reduce_events(_events())
    plain_trace = trace.reduce_events.plain(_events())
    window, busy = wrapped.window_ns, wrapped.busy
    assert window == (0, 100 * MS)
    assert busy == [(0, 20 * MS), (30 * MS, 40 * MS), (60 * MS, 70 * MS), (95 * MS, 100 * MS)]
    assert sum(e - s for s, e in busy) / 1e9 == pytest.approx(wrapped.busy_s)
    # every existing reader reads what it read on the plain reduction
    assert not hasattr(plain_trace, "busy")
    for field in ("window_s", "busy_s", "kernel_s", "idle_gaps"):
        assert getattr(wrapped, field) == getattr(plain_trace, field)
    launches = {("groupnorm", "bfloat16", (45, 128, 64, 64)): 10,
                ("attention", "bfloat16", (45, 8, 256, 256, 64)): 4}
    for name in OLD:
        r = manifest.metric_reader(name)
        assert r.read(_run(wrapped, launches)) == r.read(_run(plain_trace, launches)), name


def test_a_run_without_the_recorder_reads_nothing():
    spans._state.update(armed=False, run=None, recording=None)
    t = trace.reduce_events([Event(WINDOW, 0, MS, False)])
    run = Run(records=[Record(request={}, client_s=1.0)], window_s=1.0, setup_s=2.0,
              peak_bytes=0, trace=t)
    assert all(manifest.metric_reader(n).read(run) is None for n in NEW)


def test_a_tiny_traced_run_reports_them():
    """The tiny P2 cell, traced on the CPU: every new metric but sweep_ms
    (no CUDA events on the CPU); the warm-up's edit is inside set-up."""
    import torch

    torch.set_num_threads(2)
    cell = _tiny.p2_cell()
    cell.per_layer = list(NEW) + ["idle_share", "setup_s"]
    spans.arm()
    out = harness.run_cell(cell, 3000000019, 0, True, "cpu")
    got = out["metrics"]
    assert set(got) == set(NEW) - {"sweep_ms"} | {"idle_share", "setup_s"}
    assert 0 < got["cold_edit_s"]["value"] < got["setup_s"]["value"]
    assert got["readbacks"]["value"] >= 5 and got["readbacks"]["unit"] == "calls/edit"
    # nothing runs on the CPU's "device": the phases are all idle
    for n in ("generate_idle", "basis_idle", "strips_idle"):
        assert got[n]["value"] == pytest.approx(100.0)

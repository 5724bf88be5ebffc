"""The closed-loop window: whole requests, and a stall inside it counts."""

import itertools
import time

import _tiny  # noqa: F401
from perfbench.harness import Record, Run, drive
from perfbench import manifest


def _sender(durations):
    it = iter(durations)

    def send(req):
        d = next(it)
        time.sleep(d)
        return Record(request=req, client_s=d)

    return send


def test_the_request_in_flight_finishes_and_closes_the_window():
    recs, window_s = drive(_sender([0.05, 0.05, 0.3, 0.05]), itertools.count(), 0.12)
    assert len(recs) == 3                       # 0.05, 0.10 < 0.12; the third ends at 0.40
    assert window_s >= 0.39


def test_at_least_one_request_even_with_no_time():
    recs, _ = drive(_sender([0.01, 0.01]), itertools.count(), 0.0)
    assert len(recs) == 1


def test_a_stall_inside_the_window_counts_in_edit_s():
    steady = _sender([0.05] * 4)
    stalled = _sender([0.05, 0.25, 0.05, 0.05])
    r1, w1 = drive(steady, itertools.count(), 0.19)
    r2, w2 = drive(stalled, itertools.count(), 0.19)
    edit_s = manifest.metric_reader("edit_s")
    a = edit_s.read(Run(records=r1, window_s=w1, setup_s=0, peak_bytes=0))
    b = edit_s.read(Run(records=r2, window_s=w2, setup_s=0, peak_bytes=0))
    assert b > a * 1.5


def test_failed_requests_are_not_completed_edits():
    recs = [Record(request={}, client_s=1.0), Record(request={}, client_s=1.0, ok=False)]
    run = Run(records=recs, window_s=2.0, setup_s=0, peak_bytes=0)
    assert manifest.metric_reader("edit_s").read(run) == 2.0

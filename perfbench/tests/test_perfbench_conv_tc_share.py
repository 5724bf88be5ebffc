"""conv_tc_share on hand-made recordings: the window's conv_tc_gflop over
its conv_gflop, the warm-up request left out, and nothing read from a
program without the counters."""

import pytest

from perfbench import manifest, spans
from perfbench.harness import Record, Run

from loco_edit_tpu_torch.utils.logger import SpanRecord


class Rec:
    """A Recording's two fields."""

    def __init__(self, spans, counts):
        self.spans, self.counts = spans, counts


def _read(counts):
    s = [SpanRecord("request", rid, None, rid, 1, t, t + 10)
         for rid, t in ((1, 0), (10, 20), (20, 40))]
    run = Run(records=[Record(request={}, client_s=1.0) for _ in range(2)], window_s=1.0,
              setup_s=1.0, peak_bytes=0)
    spans._state.update(armed=True, run=run, recording=Rec(s, counts))
    try:
        return manifest.metric_reader("conv_tc_share").read(run)
    finally:
        spans._state.update(armed=False, run=None, recording=None)


def test_the_window_share_of_3xtf32_convolutions():
    # the warm-up request (id 1) is left out
    counts = {1: {"conv_gflop": 500.0}, 10: {"conv_gflop": 300.5, "conv_tc_gflop": 270.25},
              20: {"conv_gflop": 100.0, "conv_tc_gflop": 90.0, "readbacks": 4}}
    assert _read(counts) == pytest.approx(100 * 360.25 / 400.5)
    assert _read({10: {"conv_gflop": 3.0}, 20: {"conv_gflop": 1.0}}) == 0.0


def test_a_program_without_the_counters_reads_nothing():
    assert _read({10: {"readbacks": 3}, 20: {"readbacks": 5}}) is None
    spans._state.update(armed=False, run=None, recording=None)
    run = Run(records=[Record(request={}, client_s=1.0)], window_s=1.0, setup_s=1.0,
              peak_bytes=0)
    assert manifest.metric_reader("conv_tc_share").read(run) is None

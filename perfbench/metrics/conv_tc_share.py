"""conv_tc_share (layer: Models, their convolutions, ops/conv.py): the share
of the operations of the window's f32 convolutions on the card that took
the 3xTF32 route, in percent: the program's `conv_tc_gflop` counter over
its `conv_gflop` (each convolution call the models make, weighed by its
operations as the caller sees its shapes, counted once a call on either
route), over the window's requests (perfbench/spans.py). A program
without the counters reads None."""

from perfbench import spans

UNIT = "%"


def read(run):
    rec = spans.recording(run)
    reqs = spans.window_requests(rec, len(run.records)) if rec is not None else []
    counts = [rec.counts.get(r.request, {}) for r in reqs]
    total = sum(c.get("conv_gflop", 0) for c in counts)
    if not total:
        return None
    return 100.0 * sum(c.get("conv_tc_gflop", 0) for c in counts) / total

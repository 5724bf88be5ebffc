"""mfu (layer: models): the operations the window's edits need
(perfbench/flops.py, counted on the frozen reference models) over the
traced window's seconds times the H100's peak for the served dtype
(flops.MODEL_PEAK), in percent."""

UNIT = "%"


def read(run):
    if run.trace is None or not run.done:
        return None
    return 100.0 * sum(r.flops for r in run.done) / (run.trace.window_s * run.peak_flops)

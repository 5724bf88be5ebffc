"""superres_mfu (layer: sampling, the IF-II upscale): the operations of the
window's upscales (the engine's count on the frozen reference stage 2,
perfbench/flops.py: each record's `flops.superres`) over the seconds of
the window's `superres` spans times the served dtype's peak
(flops.MODEL_PEAK), in percent (perfbench/spans.py)."""

from perfbench import spans

UNIT = "%"


def read(run):
    ops = [getattr(r.flops, "superres", None) for r in run.done]
    secs = sum(s.seconds for s in spans.window_spans(run, "superres"))
    if not ops or None in ops or secs <= 0 or not run.peak_flops:
        return None
    return 100.0 * sum(ops) / (secs * run.peak_flops)

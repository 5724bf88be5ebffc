"""sweep_ms (layer: edit algebra, editing/pullback.py): the mean device time
of one pass of the subspace iteration (a `sweep` span's CUDA event pair,
resolved at the basis phase's synchronize) over the window's sweeps, in ms
(perfbench/spans.py)."""

from perfbench import spans

UNIT = "ms"


def read(run):
    ms = [s.device_ms for s in spans.window_spans(run, "sweep") if s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None

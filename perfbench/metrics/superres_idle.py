"""superres_idle (layer: sampling, the IF-II upscale): the share of the
window's `superres` spans' time (pipelines/common.py::_Phase, a program
span) in which no kernel, copy or memset ran on the card (the traced
window's merged device intervals), in percent (perfbench/spans.py)."""

from perfbench import spans

UNIT = "%"


def read(run):
    return spans.idle_share(run, "superres")

"""strips_idle (layer: sampling, the strip denoise of every frame): the share of the window's
`strips` spans' time (pipelines/common.py::_Phase, a program span) in which
no kernel, copy or memset ran on the card (the traced window's merged device
intervals), in percent (perfbench/spans.py)."""

from perfbench import spans

UNIT = "%"


def read(run):
    return spans.idle_share(run, "strips")

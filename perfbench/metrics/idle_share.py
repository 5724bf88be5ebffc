"""idle_share (layer: device, the H100 and core/device.py): the share of the
traced window in which no kernel, copy or memset ran on the card, in
percent."""

UNIT = "%"


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share

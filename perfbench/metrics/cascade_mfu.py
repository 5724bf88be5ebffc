"""cascade_mfu (layer: models, the IF cascade): `mfu` in the cells of the
IF engine: the operations the window's edits need, both stages
(perfbench/flops.py, counted on the frozen reference models), over the
traced window's seconds times the served dtype's peak, in percent."""

from perfbench import manifest

UNIT = "%"


def read(run):
    return manifest.metric_reader("mfu").read(run)

"""setup_s: from process start to the first timed request: the kernels'
load or build, the models built on the card, the benchmark's weights, and
the warm-up requests (end to end)."""

UNIT = "s"


def read(run):
    return run.setup_s

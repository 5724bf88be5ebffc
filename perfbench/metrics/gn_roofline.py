"""gn_roofline (layer: ops and kernels, ops/groupnorm.py and csrc/groupnorm.cu):
the least time of every GroupNorm launch of the traced window (its shape
from the harness's record of the entry, perfbench/flops.py's bound) over
the device time of the kernels gn_stats_kernel and gn_apply_kernel, in
percent."""

from perfbench.flops import groupnorm_least_s

UNIT = "%"
KERNELS = ("gn_stats_kernel", "gn_apply_kernel")


def read(run):
    if run.trace is None:
        return None
    device = sum(s for n, s in run.trace.kernel_s.items() if any(k in n for k in KERNELS))
    least = sum(n * groupnorm_least_s(shape, 2 if dt == "bfloat16" else 4)
                for (kind, dt, shape), n in run.launches.items() if kind == "groupnorm")
    return 100.0 * least / device if device > 0 and least > 0 else None

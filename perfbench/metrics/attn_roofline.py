"""attn_roofline (layer: ops and kernels, ops/flash_attention.py and
csrc/flash_attention.cu): the least time of every attention launch of the
traced window (its shape from the harness's record of the entry,
perfbench/flops.py's bound) over the device time of the kernels
flash_fwd_bf16_kernel, flash_fwd_f32_rows and flash_fwd_f32_cols, in
percent."""

from perfbench.flops import attention_least_s

UNIT = "%"
KERNELS = ("flash_fwd_bf16_kernel", "flash_fwd_f32_rows", "flash_fwd_f32_cols")


def read(run):
    if run.trace is None:
        return None
    device = sum(s for n, s in run.trace.kernel_s.items() if any(k in n for k in KERNELS))
    least = sum(n * attention_least_s(*shape, dt)
                for (kind, dt, shape), n in run.launches.items() if kind == "attention")
    return 100.0 * least / device if device > 0 and least > 0 else None

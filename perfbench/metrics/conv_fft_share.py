"""conv_fft_share (layer: models, their cuDNN convolutions): the device time
of cuDNN's FFT-tiling convolution kernels in the traced window (names that
hold "fft" or "region_transform", and the complex f32 GEMMs, "cf32") over
the device time of every kernel of the window, in percent."""

UNIT = "%"
MARKS = ("fft", "region_transform", "cf32")


def read(run):
    if run.trace is None:
        return None
    total = sum(run.trace.kernel_s.values())
    fft = sum(s for n, s in run.trace.kernel_s.items() if any(m in n.lower() for m in MARKS))
    return 100.0 * fft / total if total > 0 else None

"""conv_fft_share on synthetic traces: cuDNN's FFT-tiling kernels (the
names of the heuristic's choice for P2's batched f32 convolutions) over all
of the window's device time."""

import pytest

import _tiny  # noqa: F401
from perfbench import manifest
from perfbench.harness import Run
from perfbench.trace import WINDOW, Event, reduce_events

MS = 1_000_000


def _run(events):
    trace = reduce_events(events) if events is not None else None
    return Run(records=[], window_s=1.0, setup_s=1.0, peak_bytes=0, trace=trace)


def test_fft_kernels_over_all_device_time():
    run = _run([
        Event(WINDOW, 0, 100 * MS, False),
        Event("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x32x8", 0, 40 * MS, True),
        Event("void DSE::regular_fft_pad<float>", 40 * MS, 45 * MS, True),
        Event("void DSE::vector_fft<float>", 45 * MS, 50 * MS, True),
        Event("region_transform_ABC_val", 50 * MS, 55 * MS, True),
        Event("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc", 55 * MS, 75 * MS,
              True),
        Event("gn_stats_kernel<float>", 75 * MS, 80 * MS, True),
        Event("Memcpy HtoD (Pageable -> Device)", 80 * MS, 85 * MS, True),
    ])
    share = manifest.metric_reader("conv_fft_share").read(run)
    assert share == pytest.approx(100 * 55 / 85)


def test_no_fft_kernel_reads_zero_and_no_trace_reads_nothing():
    reader = manifest.metric_reader("conv_fft_share")
    run = _run([Event(WINDOW, 0, 10 * MS, False),
                Event("sm90_xmma_dgrad_implicit_gemm_f32f32", 0, 5 * MS, True)])
    assert reader.read(run) == 0.0
    assert reader.read(_run(None)) is None
    assert reader.read(_run([Event(WINDOW, 0, MS, False)])) is None

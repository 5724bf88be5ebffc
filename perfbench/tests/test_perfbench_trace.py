"""The trace reduction and the per-layer readers on synthetic events."""

import math

import pytest

import _tiny  # noqa: F401
from perfbench import flops, manifest
from perfbench.harness import Record, Run
from perfbench.trace import WINDOW, Event, reduce_events

MS = 1_000_000


def _events():
    return [
        Event(WINDOW, 0, 100 * MS, False),
        Event("outer_op", 0, 100 * MS, False),
        Event("aten::copy_", 9 * MS, 12 * MS, False),
        Event("aten::item", 60 * MS, 61 * MS, False),
        Event("gn_stats_kernel<bf16>", -5 * MS, 10 * MS, True),   # clipped at 0
        Event("gn_apply_kernel<bf16>", 5 * MS, 20 * MS, True),    # overlaps
        Event("flash_fwd_bf16_kernel<64>", 30 * MS, 40 * MS, True),
        Event("Memcpy DtoH", 60 * MS, 70 * MS, True),
        Event("late", 95 * MS, 130 * MS, True),                   # clipped at 100
    ]


def test_busy_union_clips_to_the_window():
    t = reduce_events(_events())
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx((20 + 10 + 10 + 5) / 1e3)
    assert t.idle_share == pytest.approx(1 - 0.045 / 0.1)
    assert t.kernel_s["gn_stats_kernel<bf16>"] == pytest.approx(0.010)
    assert t.kernel_s["late"] == pytest.approx(0.005)


def test_idle_gaps_are_longest_first_and_named_by_the_innermost_host_op():
    t = reduce_events(_events())
    assert [round(s * 1e3) for _, s in t.idle_gaps] == [25, 20, 10]
    names = dict((round(s * 1e3), n) for n, s in t.idle_gaps)
    assert names[20] == "outer_op"                 # 40-60 ms: only the outer op runs
    assert names[25] == "outer_op"
    assert names[10] == "outer_op"


def test_a_gap_opened_inside_an_op_takes_its_name():
    ev = [Event(WINDOW, 0, 50 * MS, False), Event("aten::linalg_eigh", 10 * MS, 30 * MS, False),
          Event("k", 0, 12 * MS, True), Event("k", 30 * MS, 50 * MS, True)]
    t = reduce_events(ev)
    assert t.idle_gaps == [("aten::linalg_eigh", pytest.approx(0.018))]


def test_no_window_annotation_is_an_error():
    with pytest.raises(ValueError):
        reduce_events([Event("k", 0, 1, True)])


def _run(trace, launches, flops_each=1e12):
    recs = [Record(request={}, client_s=2.0, secs=1.5, timings={"basis": 1.0}, forwards=3,
                   flops=flops_each) for _ in range(2)]
    return Run(records=recs, window_s=4.0, setup_s=9.0, peak_bytes=2**31,
               peak_flops=flops.MODEL_PEAK["fp32"], trace=trace, launches=launches)


def test_rooflines_divide_least_time_by_the_kernels_device_time():
    t = reduce_events(_events())
    gn_shape, att_shape = (45, 128, 64, 64), (45, 8, 256, 256, 64)
    launches = {("groupnorm", "bfloat16", gn_shape): 10,
                ("attention", "bfloat16", att_shape): 4}
    run = _run(t, launches)
    gn = manifest.metric_reader("gn_roofline").read(run)
    at = manifest.metric_reader("attn_roofline").read(run)
    gn_least = 10 * flops.groupnorm_least_s(gn_shape, 2)
    assert gn == pytest.approx(100 * gn_least / (0.010 + 0.015))
    att_least = 4 * flops.attention_least_s(*att_shape, "bfloat16")
    assert at == pytest.approx(100 * att_least / 0.010)
    n = 45 * 128 * 64 * 64
    assert flops.groupnorm_least_s(gn_shape, 2) == pytest.approx(
        max((2 * n * 2 + 2 * 128 * 4) / 3.35e12, 8 * n / 67e12))
    assert flops.attention_least_s(*att_shape, "bfloat16") == pytest.approx(
        max(2 * 45 * 8 * 512 * 64 * 2 / 3.35e12, 4 * 45 * 8 * 256 * 256 * 64 / 989e12))


def test_readers_without_a_trace_or_launches_read_nothing():
    run = _run(None, {})
    for name in ("gn_roofline", "attn_roofline", "mfu", "idle_share"):
        assert manifest.metric_reader(name).read(run) is None
    traced_no_kernels = _run(reduce_events([Event(WINDOW, 0, MS, False)]), {})
    assert manifest.metric_reader("gn_roofline").read(traced_no_kernels) is None


def test_window_and_layer_readers():
    t = reduce_events(_events())
    run = _run(t, {})
    read = {n: manifest.metric_reader(n).read(run) for n in
            ("edit_s", "setup_s", "server_ms", "basis_s", "forwards", "mfu", "idle_share",
             "peak_mem_gib", "io_s")}
    assert read["edit_s"] == 2.0 and read["setup_s"] == 9.0
    assert read["server_ms"] == pytest.approx(500.0)
    assert read["basis_s"] == 1.0 and read["forwards"] == 3
    assert read["mfu"] == pytest.approx(100 * 2e12 / (0.1 * 495e12))
    assert read["idle_share"] == pytest.approx(55.0)
    assert read["peak_mem_gib"] == 2.0
    assert read["io_s"] is None
    assert not math.isnan(read["mfu"])


def test_events_of_keeps_device_records_but_the_window_mirror():
    from torch.autograd import DeviceType

    from perfbench.trace import events_of

    class E:
        def __init__(self, name, dev, start, dur):
            self._n, self._d, self._s, self._dur = name, dev, start, dur

        def name(self):
            return self._n

        def device_type(self):
            return self._d

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._dur

    raw = [E(WINDOW, DeviceType.CPU, 0, 100), E(WINDOW, DeviceType.CUDA, 1, 98),
           E("gn_apply_kernel", DeviceType.CUDA, 10, 5), E("Memcpy DtoH", DeviceType.CUDA, 20, 3),
           E("aten::add", DeviceType.CPU, 5, 2), E("instant", DeviceType.CPU, 7, 0)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return raw

    got = [(e.name, e.start_ns, e.end_ns, e.device) for e in events_of(Prof)]
    assert got == [(WINDOW, 0, 100, False), ("gn_apply_kernel", 10, 15, True),
                   ("Memcpy DtoH", 20, 23, True), ("aten::add", 5, 7, False)]

"""The traced run: torch.profiler over the measured window, its events read
in memory (no trace file is written), reduced to the device's busy time,
the kernels' time by name and the idle gaps named by the host op that ran
at their start."""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

WINDOW = "perfbench_window"


@dataclass
class Event:
    name: str
    start_ns: int
    end_ns: int
    device: bool


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)      # device time by op name
    idle_gaps: list = field(default_factory=list)     # [(host op, seconds)]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _union(spans):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events: list[Event], top: int = 10) -> Trace:
    """Busy time, kernel sums and idle gaps of the window that the WINDOW
    annotation marks: device intervals (kernels, copies, memsets) clipped to
    it and merged; a gap is a stretch of the window with none, named by the
    innermost host op running at its start ("host" when none is)."""
    win = [e for e in events if e.name == WINDOW and not e.device]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} annotation")
    w0, w1 = min(e.start_ns for e in win), max(e.end_ns for e in win)
    kernel_ns: dict[str, int] = {}
    spans = []
    host = []
    for e in events:
        if e.device:
            s, t = max(e.start_ns, w0), min(e.end_ns, w1)
            if t > s:
                spans.append((s, t))
                kernel_ns[e.name] = kernel_ns.get(e.name, 0) + (t - s)
        elif e.name != WINDOW:
            host.append((e.start_ns, e.end_ns, e.name))
    busy = _union(spans)
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if w1 > at:
        gaps.append((at, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for g0, g1 in gaps[:top]:
        name = "host"
        i = bisect.bisect_right(starts, g0) - 1
        while i >= 0:                     # the latest-starting op still running
            if host[i][1] > g0:
                name = host[i][2]
                break
            i -= 1
        named.append((name, (g1 - g0) / 1e9))
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=sum(t - s for s, t in busy) / 1e9,
                 kernel_s={k: v / 1e9 for k, v in kernel_ns.items()}, idle_gaps=named)


def events_of(prof) -> list[Event]:
    """The profiler's raw events, without building its per-op tables: the
    device's kernels, copies and memsets (every record on the device but the
    WINDOW annotation's mirror) and the host's events."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dur = e.duration_ns()
        if dur <= 0:
            continue
        device = e.device_type() != DeviceType.CPU
        if device and e.name() == WINDOW:
            continue
        s = e.start_ns()
        out.append(Event(e.name(), s, s + dur, device))
    return out


@contextlib.contextmanager
def traced(enabled: bool, cuda: bool):
    """Profile the enclosed window (CPU ops, and the device's activity when
    `cuda`) with the WINDOW annotation around it; yields a holder whose
    `.trace` is the reduced Trace after exit (None when not enabled)."""
    class Holder:
        trace = None

    h = Holder()
    if not enabled:
        yield h
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    # CPU activity records this thread's ops (the client's, and the WINDOW
    # annotation); the server's request threads are seen through the CUDA
    # runtime calls that CUPTI records on every thread. Recording the
    # server's own ops too (profile_all_threads) doubled a traced edit.
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield h
            if cuda:
                torch.cuda.synchronize()
    h.trace = reduce_events(events_of(prof))

"""The program's own spans in a traced run, for the readers of program
spans (`generate_idle`, `basis_idle`, `strips_idle`, `sweep_ms`,
`readbacks`, `cold_edit_s`).

The harness loads a cell's per-layer readers only for a traced run, and
before it builds the served pipeline. Loading this module (`arm()`, once a
process) therefore:

- turns on the program's span recorder
  (`loco_edit_tpu_torch.utils.logger.start_recording`), so that the
  warm-up request is recorded too;
- wraps `trace.reduce_events` so that the Trace of the traced window also
  carries `busy`, its merged device intervals (ns, clipped to the window),
  and `window_ns`, the window's bounds. Every value the Trace had is
  computed as before.

The program's spans are stamped with time.time_ns(), the clock of the
profiler's events, so they line up with the device intervals. A program
without the recorder records nothing, and the readers read None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from perfbench import trace

REQUEST = "request"
EDIT = "request.edit"

_state = {"armed": False, "run": None, "recording": None}


def arm() -> None:
    """Start the program's recorder with nothing kept, and wrap the trace
    reduction once."""
    if not hasattr(trace.reduce_events, "plain"):
        plain = trace.reduce_events

        def reduce_events(events, top: int = 10):
            t = plain(events, top)
            t.window_ns, t.busy = busy_intervals(events)
            return t

        reduce_events.plain = plain
        trace.reduce_events = reduce_events
    try:
        from loco_edit_tpu_torch.utils.logger import start_recording
    except ImportError:       # a program without spans
        _state.update(armed=False, run=None, recording=None)
        return
    start_recording()
    _state.update(armed=True, run=None, recording=None)


def recording(run):
    """What the program recorded from arm() to the end of `run`: the first
    reader's call stops the recorder (the readers run after the window has
    closed) and the Recording is kept for `run`'s other readers. None when
    nothing was armed, and for any later run (one traced run a process, as
    run.py makes; call arm() again before another)."""
    if not _state["armed"]:
        return None
    if _state["run"] is None:
        from loco_edit_tpu_torch.utils.logger import stop_recording

        _state.update(run=run, recording=stop_recording())
    return _state["recording"] if _state["run"] is run else None


def busy_intervals(events) -> tuple[tuple[int, int], list]:
    """(the window's (start, end), the device's merged intervals in it),
    by reduce_events' rules: device events clipped to the WINDOW
    annotation and merged."""
    win = [e for e in events if e.name == trace.WINDOW and not e.device]
    w0, w1 = min(e.start_ns for e in win), max(e.end_ns for e in win)
    spans = [(max(e.start_ns, w0), min(e.end_ns, w1)) for e in events if e.device]
    return (w0, w1), [tuple(b) for b in trace._union([s for s in spans if s[1] > s[0]])]


def busy_within(busy: list, t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1) covered by the merged intervals `busy`."""
    i = max(bisect.bisect_right(busy, (t0,)) - 1, 0)
    total = 0
    while i < len(busy) and busy[i][0] < t1:
        s, e = busy[i]
        total += max(0, min(e, t1) - max(s, t0))
        i += 1
    return total


def window_requests(rec, n: int) -> list:
    """The last n request spans: the window's requests (the warm-up's come
    first)."""
    roots = sorted((s for s in rec.spans if s.name == REQUEST), key=lambda s: s.t0_ns)
    return roots[len(roots) - n:] if n else []


def window_spans(run, name: str) -> list:
    """The spans named `name` of the window's requests."""
    rec = recording(run)
    if rec is None:
        return []
    ids = {s.request for s in window_requests(rec, len(run.records))}
    return [s for s in rec.spans if s.name == name and s.request in ids]


def idle_share(run, name: str) -> float | None:
    """The share of the window's `name` spans' time with no device interval
    in it, in percent."""
    busy = getattr(run.trace, "busy", None) if run.trace is not None else None
    spans = window_spans(run, name)
    if busy is None or not spans:
        return None
    total = sum(s.t1_ns - s.t0_ns for s in spans)
    idle = total - sum(busy_within(busy, s.t0_ns, s.t1_ns) for s in spans)
    return 100.0 * idle / total if total > 0 else None


def idle_by_span(spans: list, window_ns: tuple[int, int], busy: list,
                 top: int = 10) -> list:
    """The window's idle seconds summed by the innermost span open at each
    gap's start (the latest-starting one still open; "none" when no span
    is), largest first, top `top`: [(name, seconds)]."""
    w0, w1 = window_ns
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    order = sorted(spans, key=lambda s: s.t0_ns)
    sums: dict = defaultdict(int)
    open_, j = [], 0
    for g0, g1 in gaps:
        while j < len(order) and order[j].t0_ns <= g0:
            open_.append(order[j])
            j += 1
        while open_ and open_[-1].t1_ns <= g0:
            open_.pop()
        name = "none"
        for s in reversed(open_):
            if s.t1_ns > g0:
                name = s.name
                break
        sums[name] += g1 - g0
    return sorted(((n, v / 1e9) for n, v in sums.items()), key=lambda kv: -kv[1])[:top]


arm()

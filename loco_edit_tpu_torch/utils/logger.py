"""Training/observability logger (port of loco_edit_tpu/utils/logger.py).

Key-value accumulation with mean aggregation (logkv / logkv_mean /
dumpkvs), a human-readable stdout table, JSONL and CSV writers (and
TensorBoard through tensorboardX when asked for), and wall-time profile
scopes, writing the same files as the JAX package's Logger.

Program spans: named, nested regions of a served edit (a request, its
phases, the subspace iteration's sweeps, every wait of the host for the
card), each stamped with time.time_ns() at entry and exit, the clock
torch.profiler stamps its events with, so spans line up with a device
trace. The recorder is off by default; then `span()` is one flag check
that returns a shared null context. `start_recording()` turns it on and
`stop_recording()` turns it off and hands over what it kept (a
`Recording`: the spans and, per request, the counters of `count()`:
`readbacks`, each wait of the host for the card, and `sr_forwards`, the IF
upscaler's U-Net calls, pipelines/superres.py). Nothing is written while
it records.

`device_trace(log_dir)` is the counterpart of the JAX package's
`tpu_trace`: a torch.profiler trace of the enclosed work (CPU activity,
plus CUDA activity when the card is used) written as a Chrome trace to
`log_dir/trace.json`, with the spans recorded in its window on a track of
their own.
"""

from __future__ import annotations

import contextlib
import csv
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any

# the user annotation that spans a device_trace window in its trace
TRACE_WINDOW = "loco_device_trace"
# the root span of one served request; every span below it carries its id
REQUEST = "request"


class Logger:
    def __init__(self, log_dir: str | None = None,
                 formats: tuple[str, ...] = ("stdout", "json")):
        self.log_dir = log_dir
        self.formats = formats
        self._kv: dict[str, float] = {}
        self._kv_sum: dict[str, float] = defaultdict(float)
        self._kv_cnt: dict[str, int] = defaultdict(int)
        self._prof: dict[str, float] = defaultdict(float)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self._csv_keys: list[str] | None = None
        self._tb = None
        self._tb_step = 0
        if log_dir and "tensorboard" in formats:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    # -- kv api ------------------------------------------------------------------

    def logkv(self, key: str, val: Any) -> None:
        self._kv[key] = float(val)

    def logkv_mean(self, key: str, val: Any) -> None:
        self._kv_sum[key] += float(val)
        self._kv_cnt[key] += 1

    def dumpkvs(self) -> dict[str, float]:
        out = dict(self._kv)
        for k in self._kv_sum:
            out[k] = self._kv_sum[k] / max(self._kv_cnt[k], 1)
        for k, v in self._prof.items():
            out[f"time/{k}"] = v
        self._kv.clear()
        self._kv_sum.clear()
        self._kv_cnt.clear()
        self._prof.clear()
        if "stdout" in self.formats:
            self._write_stdout(out)
        if self.log_dir and "json" in self.formats:
            with open(os.path.join(self.log_dir, "progress.jsonl"), "a") as f:
                f.write(json.dumps(out) + "\n")
        if self.log_dir and "csv" in self.formats:
            self._write_csv(out)
        if self._tb is not None:
            step = int(out.get("step", self._tb_step))
            for k, v in out.items():
                self._tb.add_scalar(k, v, step)
            self._tb.flush()
            self._tb_step += 1
        return out

    def _write_stdout(self, kv: dict[str, float]) -> None:
        if not kv:
            return
        width = max(len(k) for k in kv) + 2
        print("-" * (width + 14))
        for k in sorted(kv):
            print(f"| {k:<{width}}| {kv[k]:<10.5g}|")
        print("-" * (width + 14))

    def _write_csv(self, kv: dict[str, float]) -> None:
        path = os.path.join(self.log_dir, "progress.csv")
        if self._csv_keys is None:
            self._csv_keys = sorted(kv)
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(self._csv_keys)
        with open(path, "a", newline="") as f:
            csv.writer(f).writerow([kv.get(k, "") for k in self._csv_keys])

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    # -- profiling scopes --------------------------------------------------------

    @contextlib.contextmanager
    def profile(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._prof[name] += time.perf_counter() - t0


# -- program spans -------------------------------------------------------------

_ON = False                      # the recorder's one flag
_REC: Recording | None = None    # what it keeps while on
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_STACK = threading.local()       # .open: this thread's open spans, innermost last


@dataclass
class SpanRecord:
    """One recorded span. parent: the id of the innermost span open on the
    same thread at entry (None at a root); request: the id of the REQUEST
    span it lies in (None outside one); t0_ns/t1_ns: time.time_ns();
    device_ms: the device time between the span's CUDA events (spans
    opened with device=True on a card), resolved after a synchronize."""
    name: str
    id: int
    parent: int | None
    request: int | None         # a REQUEST span's own id
    thread: int
    t0_ns: int = 0
    t1_ns: int = 0
    device_ms: float | None = None
    attrs: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


@dataclass
class Recording:
    """What the recorder kept: the closed spans in closing order, and the
    counters by request id (None: counted outside a request)."""
    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    pending: list = field(default_factory=list)   # (record, start, end) CUDA events


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def _open_spans() -> list:
    st = _STACK.__dict__.get("open")
    if st is None:
        st = _STACK.open = []
    return st


class Span:
    """A timed region: time.time_ns() at entry and exit, always (`seconds`
    reads them); recorded while the recorder is on. device=True adds a
    timed CUDA event pair on the current stream, no synchronize."""

    def __init__(self, name: str, device: bool = False, **attrs):
        self.name, self.device, self.attrs = name, device, attrs
        self.t0_ns = self.t1_ns = 0
        self._rec = None

    def __enter__(self):
        if _ON:
            st = _open_spans()
            parent = st[-1] if st else None
            sid = next(_IDS)
            req = sid if self.name == REQUEST else parent.request if parent else None
            self._rec = SpanRecord(self.name, sid, parent.id if parent else None, req,
                                   threading.get_ident(), attrs=self.attrs)
            self._into = _REC
            st.append(self._rec)
            if self.device:
                import torch

                self._events = [torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)]
                self._events[0].record()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None and self.device:
            self._events[1].record()
        self.t1_ns = time.time_ns()
        if rec is not None:
            self._rec = None
            rec.t0_ns, rec.t1_ns = self.t0_ns, self.t1_ns
            st = _open_spans()
            if rec in st:
                del st[st.index(rec):]
            with _LOCK:
                if self._into is not None and self._into is _REC:
                    _REC.spans.append(rec)
                    if self.device:
                        _REC.pending.append((rec, *self._events))
        return False

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def current_span() -> SpanRecord | None:
    """The innermost span recorded open on this thread (None when none is)."""
    st = _open_spans()
    return st[-1] if st else None


@contextlib.contextmanager
def carried(parent: SpanRecord | None):
    """Open spans and count on this thread as inside `parent`, a span open
    on another thread (its current_span()), so that work handed to another
    thread stays in its request. None: nothing to carry."""
    if parent is None:
        yield
        return
    st = _open_spans()
    st.append(parent)
    try:
        yield
    finally:
        if parent in st:
            del st[st.index(parent):]


def span(name: str, device: bool = False, **attrs):
    """A Span while the recorder is on, else the shared null context."""
    return Span(name, device, **attrs) if _ON else _NULL


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the request this thread is in."""
    if not _ON:
        return
    st = _open_spans()
    req = st[-1].request if st else None
    with _LOCK:
        if _REC is not None:
            c = _REC.counts.setdefault(req, {})
            c[name] = c.get(name, 0) + n


def readback():
    """Around a wait of the host for the card (a copy to the host, a copy
    from pageable host memory, a synchronize): a `readback` span, and one
    on the `readbacks` counter."""
    if not _ON:
        return _NULL
    count("readbacks")
    return Span("readback")


def resolve_device_times() -> None:
    """Turn the device=True spans' finished CUDA event pairs into
    device_ms. Waits for nothing: call it after a synchronize."""
    if not _ON:
        return
    with _LOCK:
        pending = _REC.pending if _REC is not None else []
        left = []
        for rec, e0, e1 in pending:
            if e1.query():
                rec.device_ms = e0.elapsed_time(e1)
            else:
                left.append((rec, e0, e1))
        pending[:] = left


def start_recording() -> None:
    """Turn the recorder on with nothing kept."""
    global _ON, _REC
    with _LOCK:
        _REC = Recording()
    _ON = True


def stop_recording() -> Recording:
    """Turn the recorder off; returns what it kept (an empty Recording when
    it was off)."""
    global _ON, _REC
    resolve_device_times()
    _ON = False
    with _LOCK:
        rec, _REC = _REC or Recording(), None
    rec.pending = []
    return rec


def recording() -> bool:
    """Whether the recorder is on."""
    return _ON


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: bool | None = None):
    """Trace the enclosed work with torch.profiler and write it as a Chrome
    trace to log_dir/trace.json (view it in Perfetto or chrome://tracing).
    CPU activity always; CUDA activity when `cuda` (default: a card is
    present). The window is marked by a TRACE_WINDOW annotation; the
    recorder is on inside it, and its spans are added to the trace on a
    track of their own ("loco spans"). Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        start_recording()
        try:
            with record_function(TRACE_WINDOW):
                yield prof
            if cuda:
                torch.cuda.synchronize()
        finally:
            rec = stop_recording()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    add_spans_to_trace(path, rec.spans)


def add_spans_to_trace(path: str, spans: list) -> None:
    """Append spans to a Chrome trace as complete events of their own
    process ("loco spans", one track per thread), on the trace's time base
    (microseconds after its baseTimeNanoseconds)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)),
                  default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": "loco spans"}})
    for s in spans:
        args = {"id": s.id, "parent": s.parent, "request": s.request, **s.attrs}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append({"ph": "X", "cat": "loco_span", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": (s.t0_ns - base) / 1e3,
                       "dur": (s.t1_ns - s.t0_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)

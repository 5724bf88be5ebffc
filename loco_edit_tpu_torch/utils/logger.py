"""Training/observability logger (port of loco_edit_tpu/utils/logger.py).

Key-value accumulation with mean aggregation (logkv / logkv_mean /
dumpkvs), a human-readable stdout table, JSONL and CSV writers (and
TensorBoard through tensorboardX when asked for), and wall-time profile
scopes, writing the same files as the JAX package's Logger.

`device_trace(log_dir)` is the counterpart of the JAX package's
`tpu_trace`: a torch.profiler trace of the enclosed work (CPU activity,
plus CUDA activity when the card is used) written as a Chrome trace to
`log_dir/trace.json`. `device_busy_share(path)` reads such a trace back:
the share of the traced window in which a kernel or a copy ran on the card.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import time
from collections import defaultdict
from typing import Any

# the user annotation that spans a device_trace window in its trace
TRACE_WINDOW = "loco_device_trace"
# Chrome-trace categories of device work (kernels, copies, memsets)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: bool | None = None):
    """Trace the enclosed work with torch.profiler and write it as a Chrome
    trace to log_dir/trace.json (view it in Perfetto or chrome://tracing).
    CPU activity always; CUDA activity when `cuda` (default: a card is
    present). The window is marked by a TRACE_WINDOW annotation. Yields the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(TRACE_WINDOW):
            yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _union_ms(spans: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total / 1e3


def device_busy_share(trace_path: str) -> dict:
    """Read a device_trace Chrome trace: the traced window (the TRACE_WINDOW
    annotation on the host), the union of the device's kernel, copy and
    memset intervals inside it, and their ratio. Times in ms; "events"
    counts the device events."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == TRACE_WINDOW and e.get("ph") == "X"]
    if not win:
        raise ValueError(f"{trace_path}: no {TRACE_WINDOW} window")
    w0 = min(float(e["ts"]) for e in win)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in win)
    spans = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0)), w1))
             for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    spans = [s for s in spans if s[1] > s[0]]
    window_ms = (w1 - w0) / 1e3
    busy_ms = _union_ms(spans)
    return {"window_ms": window_ms, "busy_ms": busy_ms,
            "share": busy_ms / window_ms if window_ms > 0 else 0.0,
            "events": len(spans)}

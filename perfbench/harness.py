"""One run of one cell: set-up, the measured window of served edits, the
readings, and the comparison with the plain reference that decides
`correct`.

Set-up starts the program's edit server (`loco_edit_tpu_torch.serve`:
`make_server(EditService(args))`) on a thread of this process, on port 0,
puts the benchmark's seeded weights into its models and sends the mix's
warm-up requests. The window is one closed-loop client: it POSTs /edit
back to back until `seconds` have passed, lets the request in flight
finish and closes when its answer arrives. After the window the server is
shut down, the program's state freed, and the plain reference judges a
sample of the window's edits drawn from the seed.
"""

from __future__ import annotations

import base64
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field

import numpy as np

from perfbench import flops, inputs, manifest, trace, traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "loco_edit_tpu"}


def log(t_start: float, msg: str) -> None:
    print(f"perfbench {time.perf_counter() - t_start:8.2f} s: {msg}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules of the JAX side, compared by whole top-level names
    (so loco_edit_tpu_torch passes)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Record:
    """One answered request of the window."""
    request: dict
    client_s: float
    secs: float = 0.0
    timings: dict = field(default_factory=dict)
    forwards: int = 0
    flops: float = 0.0
    boost_index: int = 0        # edits the pipeline served before this one
    answer: dict | None = None
    ok: bool = True


@dataclass
class Run:
    """What the metric readers read."""
    records: list
    window_s: float
    setup_s: float
    peak_bytes: int
    peak_flops: float = 0.0     # the served dtype's peak (flops.MODEL_PEAK)
    trace: object = None        # trace.Trace of a traced run
    launches: dict = field(default_factory=dict)   # (kernel, dtype, shape) -> count

    @property
    def done(self) -> list:
        return [r for r in self.records if r.ok]


def post(url: str, payload: dict) -> tuple[dict | None, float]:
    """POST JSON; (the answer or None when the server refused, host seconds)."""
    data = json.dumps(payload).encode()
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=600) as r:
            out = json.loads(r.read())
    except urllib.error.HTTPError as e:
        print(f"request failed: {e.code} {e.read()[:300]!r}", file=sys.stderr, flush=True)
        out = None
    return out, time.perf_counter() - t0


def decode_strips(answer: dict) -> dict[int, np.ndarray]:
    dt = np.uint8 if answer["dtype"] == "uint8" else np.float32
    return {int(pc): np.frombuffer(base64.b64decode(b), dt).reshape(answer["shape"])
            for pc, b in answer["strips"].items()}


class Launches:
    """Counts the GroupNorm and attention entries' launches by shape while
    on, by wrapping the ops modules' entry functions (what
    chip_smoke.py::recording_calls does)."""

    def __init__(self):
        self.counts: dict = {}

    def __enter__(self):
        from loco_edit_tpu_torch.ops import flash_attention as fa
        from loco_edit_tpu_torch.ops import groupnorm as gn

        self._mods = [(gn, "group_norm_cuda", gn.group_norm_cuda,
                       lambda x, *a, **k: ("groupnorm", str(x.dtype).split(".")[1],
                                           tuple(x.shape))),
                      (fa, "flash_attention_cuda", fa.flash_attention_cuda,
                       lambda q, k, v: ("attention", str(q.dtype).split(".")[1],
                                        (*q.shape[:3], k.shape[2], q.shape[3])))]
        for mod, attr, fn, key in self._mods:
            setattr(mod, attr, self._wrap(fn, key))
        return self

    def _wrap(self, fn, key):
        counts = self.counts

        def wrapped(*a, **k):
            kk = key(*a, **k)
            counts[kk] = counts.get(kk, 0) + 1
            return fn(*a, **k)

        wrapped.__dict__.update(fn.__dict__)
        return wrapped

    def __exit__(self, *exc):
        for mod, attr, fn, _ in self._mods:
            setattr(mod, attr, fn)


class ForwardCount:
    """Forward calls of the given modules (a pre-hook each; a vmap, jvp or
    vjp calls forward once)."""

    def __init__(self, modules):
        self.n = 0
        self.handles = [m.register_forward_pre_hook(self._hook) for m in modules]

    def _hook(self, *_):
        self.n += 1

    def remove(self):
        for h in self.handles:
            h.remove()


def drive(send, requests, seconds: float):
    """The closed-loop window: send() each request after the previous one
    answered, until `seconds` have passed; the request in flight then
    finishes and the window closes when its answer arrives. Returns (the
    records, the window's seconds)."""
    records = []
    t0 = time.perf_counter()
    while True:
        records.append(send(next(requests)))
        if time.perf_counter() - t0 >= seconds:
            return records, time.perf_counter() - t0


def within_limits(checks: dict, limits: dict) -> bool:
    """Every compared number at or under its limit (a missing number, or a
    limit not set, fails)."""
    return all(lim is not None and checks.get(n, float("inf")) <= lim
               for n, lim in limits.items())


def card_name_and_limit() -> tuple[str, str]:
    import subprocess

    import torch

    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = "not read"
    return name, limit


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None,
             bench_dir: str = manifest.HERE, workdir: str | None = None) -> dict:
    """One run of `cell`; returns the result line's fields, "checks" last."""
    import torch

    from loco_edit_tpu_torch.serve import make_server

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device == "cuda"
    eng_mod = manifest.engine_module(cell.config["engine"], bench_dir)
    readers = {m: manifest.metric_reader(m, bench_dir)
               for m in (cell.per_layer if traced else cell.end_to_end)}
    work = tempfile.mkdtemp(prefix="perfbench-", dir=workdir)
    environ = dict(os.environ)      # the program's seeding sets PYTHONHASHSEED
    try:
        engine = eng_mod.Engine(cell.config, device=device,
                                weight_seed=inputs.sub_seed(seed, "weights"),
                                server_seed=inputs.sub_seed(seed, "server") or 1,
                                prompt_seed=inputs.sub_seed(seed, "prompts"))
        log(t_start, "building the served pipeline")
        svc = engine.build(os.path.join(work, "results"))
        log(t_start, "pipeline built, the benchmark's weights in; warm-up")
        models = engine.models()
        fwd = ForwardCount(models.values())
        srv = make_server(svc, port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}/edit"
        warm, window = traffic.requests(cell.traffic, inputs.sub_seed(seed, "traffic"),
                                        engine.mask_hw)
        served = 0
        for req in warm:
            ans, _ = post(url, req)
            if ans is None:
                raise RuntimeError(f"a warm-up request failed: {req}")
            served += 1
        bad = forbidden_modules()
        if bad:
            raise SystemExit(f"set-up loaded modules of the JAX side: {bad}")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        log(t_start, f"set-up done; the window opens for {seconds} s")

        def send(req):
            nonlocal served
            n0 = fwd.n
            ans, client_s = post(url, req)
            rec = Record(request=req, client_s=client_s, boost_index=served,
                         forwards=fwd.n - n0, ok=ans is not None, answer=ans,
                         flops=engine.flops)
            served += 1
            if ans is not None:
                rec.secs = float(ans["secs"])
                rec.timings = dict(svc.pipe.timings)
            return rec

        launches = Launches()
        with trace.traced(traced, cuda) as tr, (
                launches if traced else contextlib.nullcontext()):
            records, window_s = drive(send, window, seconds)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        log(t_start, f"window closed: {len(records)} requests in {window_s:.3f} s")
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
        fwd.remove()
        run = Run(records=records, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
                  peak_flops=flops.MODEL_PEAK[cell.config["dtype"]], trace=tr.trace,
                  launches=launches.counts)
        metrics = {}
        for name, reader in readers.items():
            v = reader.read(run)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": reader.UNIT}
        bad = forbidden_modules()
        if bad:
            raise SystemExit(f"the run loaded modules of the JAX side: {bad}")

        # the program's state goes before the reference runs
        del svc, srv, models, fwd
        engine.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        sample_rng = np.random.default_rng(inputs.sub_seed(seed, "sample"))
        done = [i for i, r in enumerate(records) if r.ok]
        k = min(int(cell.config["check"]["requests"]), len(done))
        picked = sorted(sample_rng.choice(done, size=k, replace=False).tolist()) if k else []
        checks = engine.judge([records[i] for i in picked]) if picked else {}
        log(t_start, f"judged request(s) {picked} against the reference")
        failed = sum(not r.ok for r in records)
        limits = cell.config["check"]["limits"]
        correct = bool(picked) and failed == 0 and within_limits(checks, limits)
        out = {"correct": correct, "attempted": len(records), "failed": failed,
               "metrics": metrics}
        if cuda:
            name, limit = card_name_and_limit()
            out["device"] = {"platform": "gpu", "kind": name, "count": cell.chips,
                             "memory_peak_bytes": int(peak), "power_limit": limit}
        else:
            out["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                             "memory_peak_bytes": 0}
        if tr.trace is not None:
            t = tr.trace
            out["device"]["busy_s"] = t.busy_s
            out["device"]["window_s"] = t.window_s
            top = sorted(t.kernel_s.items(), key=lambda kv: -kv[1])[:10]
            out["breakdown"] = {"device_ops": [[n[:160], s] for n, s in top],
                                "idle_gaps": [[n[:160], s] for n, s in t.idle_gaps]}
        out["checks"] = {n: {"value": checks.get(n), "limit": lim}
                         for n, lim in limits.items()}
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)
        os.environ.clear()
        os.environ.update(environ)

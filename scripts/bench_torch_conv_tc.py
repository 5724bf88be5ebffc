"""Each convolution signature a benchmark cell's served edit runs on the
3xTF32 route (loco_edit_tpu_torch/ops/conv.py), timed on the route and on
the f32 engines, on one card.

    python scripts/bench_torch_conv_tc.py --cell if_edit [--seed N] [--out DIR]
    python scripts/bench_torch_conv_tc.py --tables DIR/conv_tc_<cell>.json ...

A run builds the cell's served pipeline as perfbench/harness.py does (the
configuration's engine, seeded weights, the server), sends the traffic's
warm-up request, and keeps each signature (pass, shapes, layout, geometry)
that the route ran in it and its number of calls. Then, on the server's
device thread, for each signature:

- both routes timed back to back (CUDA events over REPS calls, the least
  of two turns), on seeded data of the signature's shapes;
- the largest error of each route against a float64 convolution of the
  same data (the first batch element; cuDNN's float64 on the card, whose
  own rounding, ~1e-16, is nothing here), over the largest value.

It writes DIR/conv_tc_<cell>.json and prints the tables (markdown);
--tables prints them from saved files (one cell's, or a list of cells')
without a card. Run it from the repository's root with PYTHONPATH=. .
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys
import tempfile
import threading
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10


def _measure(key, calls: int) -> dict:
    """Both routes of one signature, timed and held to float64 (run on the
    device thread)."""
    import torch
    import torch.nn.functional as F

    from loco_edit_tpu_torch.ops import conv

    kind, shape, channels_last, w_shape, geo = key[:5]
    g = torch.Generator("cuda").manual_seed(zlib.crc32(repr(key).encode()))
    x = torch.randn(shape, device="cuda", generator=g)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    fan_in = (w_shape[0] if kind == "dgrad" else w_shape[1]) * w_shape[2] * w_shape[3]
    w = torch.nn.Parameter(torch.randn(w_shape, device="cuda", generator=g) / fan_in ** 0.5)
    if kind == "fprop":
        def f32():
            return F.conv2d(x, w, None, geo.stride, geo.padding, geo.dilation)

        def tc():
            return conv.conv_forward(x, w, None, geo)

        def exact():
            return F.conv2d(x[:1].double(), w.double(), None, geo.stride, geo.padding,
                            geo.dilation)
        chunks = conv.chunks(w_shape[1], w_shape[2] * w_shape[3])
    else:
        in_hw = key[5]
        pad = tuple(in_hw[i] - ((shape[2 + i] - 1) * geo.stride[i] - 2 * geo.padding[i]
                                + geo.dilation[i] * (w_shape[2 + i] - 1) + 1) for i in range(2))

        def f32():
            return F.conv_transpose2d(x, w, None, geo.stride, geo.padding, pad, 1, geo.dilation)

        def tc():
            return conv.conv_input_grad(x, w, geo, in_hw)

        def exact():
            return F.conv_transpose2d(x[:1].double(), w.double(), None, geo.stride,
                                      geo.padding, pad, 1, geo.dilation)
        chunks = conv.chunks(w_shape[0], w_shape[2] * w_shape[3])

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(2):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                fn()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) / REPS)
        return best

    ref = exact()

    def err(y) -> float:
        return float((y[:1].detach().double() - ref).abs().max() / ref.abs().max())

    f32_ms, tc_ms = timed(f32), timed(tc)
    y = f32()
    # the forward's output elements x C kh kw, twice (dgrad: x is that output's gradient)
    flop = 2.0 * math.prod(y.shape if kind == "fprop" else shape) * math.prod(w_shape[1:])
    out = {"pass": kind, "shape": list(shape), "channels_last": channels_last,
           "weight": list(w_shape), "stride": list(geo.stride), "padding": list(geo.padding),
           "calls": calls, "flop": flop, "chunks": chunks, "f32_ms": f32_ms, "tc_ms": tc_ms,
           "f32_err": err(y), "tc_err": err(tc())}
    del x, w
    torch.cuda.empty_cache()
    return out


def run(cell_name: str, seed: int, out_dir: str) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    from perfbench import harness, inputs, manifest, traffic
    from loco_edit_tpu_torch.ops import conv
    from loco_edit_tpu_torch.serve import make_server

    cell = manifest.load_cell(ROOT, cell_name)
    calls = collections.Counter()
    forward, input_grad = conv.conv_forward, conv.conv_input_grad

    def _layout(t):
        return t.is_contiguous(memory_format=torch.channels_last)

    def counted_forward(x, w, b, geo):
        calls[("fprop", tuple(x.shape), _layout(x), tuple(w.shape), geo)] += 1
        return forward(x, w, b, geo)

    def counted_input_grad(gy, w, geo, in_hw):
        calls[("dgrad", tuple(gy.shape), _layout(gy), tuple(w.shape), geo, tuple(in_hw))] += 1
        return input_grad(gy, w, geo, in_hw)

    conv.conv_forward, conv.conv_input_grad = counted_forward, counted_input_grad
    eng = manifest.engine_module(cell.config["engine"]).Engine(
        cell.config, device="cuda", weight_seed=inputs.sub_seed(seed, "weights"),
        server_seed=inputs.sub_seed(seed, "server") or 1,
        prompt_seed=inputs.sub_seed(seed, "prompts"))
    with tempfile.TemporaryDirectory() as work:
        svc = eng.build(os.path.join(work, "results"))
        srv = make_server(svc, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}/edit"
        warm, _ = traffic.requests(cell.traffic, inputs.sub_seed(seed, "traffic"), eng.mask_hw)
        t0 = time.perf_counter()
        ans, client_s = harness.post(url, warm[0])
        if ans is None:
            raise RuntimeError(f"the warm-up request failed: {warm[0]}")
        cold_s = time.perf_counter() - t0
        conv.conv_forward, conv.conv_input_grad = forward, input_grad
        rows = [svc.on_device(_measure, key, n) for key, n in calls.items()]
        srv.shutdown()
        srv.server_close()
    name, limit = harness.card_name_and_limit()
    result = {"cell": cell_name, "seed": seed, "device": name, "power_limit": limit,
              "torch": torch.__version__, "cudnn": torch.backends.cudnn.version(),
              "max_depth": conv.MAX_DEPTH, "cold_edit_s": cold_s, "rows": rows}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"conv_tc_{cell_name}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def _sig(r: dict) -> str:
    """The forward's channels (c_in -> c_out), the kernel, the stride, and
    the spatial size of the pass's input (dgrad: the output gradient)."""
    h, w = r["shape"][2:]
    c_out, c_in, kh, kw = r["weight"]
    s = f", stride {r['stride'][0]}" if r["stride"][0] != 1 else ""
    return f"{c_in} -> {c_out}, {kh}x{kw}{s}, {h} x {w}"


def tables(results: list) -> str:
    lines = []
    for res in results:
        rows = sorted(res["rows"], key=lambda r: (r["pass"], -r["calls"] * r["f32_ms"]))
        lines += [f"### `{res['cell']}` (seed {res['seed']}; {res['device']}, power limit "
                  f"{res['power_limit']}; PyTorch {res['torch']}, cuDNN {res['cudnn']}; "
                  f"MAX_DEPTH {res['max_depth']})", "",
                  "| pass | c_in -> c_out, k, H x W of the pass's input | batch | layout "
                  "| calls an edit | GFLOP | chunks | f32 ms | 3xTF32 ms "
                  "| f32 / 3xTF32 error vs float64 |",
                  "|---|---|---|---|---|---|---|---|---|---|"]
        for r in rows:
            lines.append(
                f"| {r['pass']} | {_sig(r)} | {r['shape'][0]} | "
                f"{'NHWC' if r['channels_last'] else 'NCHW'} | {r['calls']} "
                f"| {r['flop'] / 1e9:.1f} | {r['chunks']} "
                f"| {r['f32_ms']:.3f} | {r['tc_ms']:.3f} | "
                f"{r['f32_err']:.2g} / {r['tc_err']:.2g} |")
        f32 = sum(r["calls"] * r["f32_ms"] for r in rows) / 1e3
        tc = sum(r["calls"] * r["tc_ms"] for r in rows) / 1e3
        worst = max((r["tc_err"] / r["f32_err"] for r in rows), default=float("nan"))
        lines += ["", f"{len(rows)} signatures, {sum(r['calls'] for r in rows)} routed calls "
                  f"an edit; their seconds (times above x calls): {f32:.2f} s on the f32 "
                  f"engines, {tc:.2f} s on 3xTF32; the warm-up edit took "
                  f"{res['cold_edit_s']:.1f} s; 3xTF32's error at most {worst:.2g} times "
                  f"the f32 engines'.", ""]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default=None)
    ap.add_argument("--seed", type=int, default=2150000417)
    ap.add_argument("--out", default=".")
    ap.add_argument("--tables", nargs="*", default=None)
    args = ap.parse_args(argv)
    if args.tables:
        results = []
        for path in args.tables:
            with open(path) as f:
                data = json.load(f)
            results += data if isinstance(data, list) else [data]
    else:
        results = [run(args.cell, args.seed, args.out)]
    print(tables(results))


if __name__ == "__main__":
    main()

"""Each FFHQ_P2 convolution in full f32 on one card, under cuDNN's heuristic
choice of algorithm and under its measured choice (torch.backends.cudnn.
benchmark, the port's f32 policy: core/device.py::use_full_f32).

    python scripts/bench_torch_conv_choice.py [--batches 1 3 5 9] [--limits 3 5]
                                              [--out DIR]
    python scripts/bench_torch_conv_choice.py --tables DIR/conv_choice.json

The signatures are those of one P2 forward (recorded on the meta device)
at each batch, in the layouts the model runs them: the forward pass
(fprop) on channels_last activations, the gradient with respect to the
input (dgrad, what the basis's vjp runs) on contiguous NCHW gradients.
Each choice runs in a process of its own: cuDNN keeps the first plan it
finds for a signature, per thread. The choices: the heuristic, the
measured choice with PyTorch's 10 candidates (benchmark_limit), with the
port's number and with each of --limits. For each case a process records
the first call's milliseconds (under a measured choice it holds the
measurement), the steady milliseconds (CUDA events over repeated calls)
and the kernel that took the most device time in one profiled call.

The script writes DIR/conv_choice.json and prints its tables (markdown):
one row per signature and batch (fprop and dgrad under the heuristic, 10
candidates and the port's, with each kernel's family, and the first calls
under the port's); the sums of one forward's convolutions at each batch;
the sums under every number of candidates measured. --tables prints the
same tables from a saved conv_choice.json, without a card
(docs/CONV_CHOICE_P2.md holds one such print).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFT_MARKS = ("fft", "region_transform", "cf32")


def p2_conv_signatures() -> dict:
    """(c_in, c_out, kernel, stride, H, W) -> calls in one FFHQ_P2 forward,
    from a forward on the meta device (GroupNorm and attention replaced by
    the identity, which keeps their shapes)."""
    sys.path.insert(0, ROOT)
    from loco_edit_tpu_torch.models.adm import ADMUNet, unet
    from loco_edit_tpu_torch.models.adm.presets import adm_preset

    seen = collections.Counter()

    def hook(mod, args):
        h, w = args[0].shape[-2:]
        seen[(mod.in_channels, mod.out_channels, mod.kernel_size[0], mod.stride[0],
              int(h), int(w))] += 1

    saved = unet.group_norm_f32, unet.sdp_attention
    unet.group_norm_f32, unet.sdp_attention = (lambda x, s, b: x), (lambda q, k, v: q)
    try:
        with torch.device("meta"):
            model = ADMUNet(adm_preset("FFHQ_P2"))
            for m in model.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.register_forward_pre_hook(hook)
            model(torch.zeros(1, 256, 256, 3), 500.0)
    finally:
        unet.group_norm_f32, unet.sdp_attention = saved
    return dict(sorted(seen.items()))


def family(name: str) -> str:
    n = name.lower()
    if any(m in n for m in FFT_MARKS):
        return "fft"
    if "winograd" in n:
        return "winograd"
    if "implicit" in n or "xmma_fprop" in n or "xmma_dgrad" in n:
        return "gemm"
    return "direct"


def policy_limit() -> int:
    """The number of candidates the port's f32 policy lets cuDNN measure."""
    sys.path.insert(0, ROOT)
    from loco_edit_tpu_torch.core.device import use_full_f32

    use_full_f32(torch.float32)
    return torch.backends.cudnn.benchmark_limit


def _case(sig, batch: int, pas: str):
    """The call of one case, on fresh seeded tensors on the card."""
    cin, cout, k, stride, h, w = sig
    g = torch.Generator("cuda").manual_seed(batch * 1000 + cin)
    x = torch.randn(batch, h, w, cin, device="cuda", generator=g).permute(0, 3, 1, 2)
    wt = torch.randn(cout, cin, k, k, device="cuda", generator=g) / (cin * k * k) ** 0.5
    bias = torch.randn(cout, device="cuda", generator=g)
    if pas == "fprop":
        return lambda: F.conv2d(x, wt, bias, stride, k // 2)
    x = x.contiguous()
    dy = torch.randn(batch, cout, h // stride, w // stride, device="cuda", generator=g)
    return lambda: torch.ops.aten.convolution_backward(
        dy, x, wt, None, [stride] * 2, [k // 2] * 2, [1, 1], False, [0, 0], 1,
        [True, False, False])[0]


def _ms(fn, reps: int) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def measure(mode: str, batches, limit: int | None = None) -> list[dict]:
    """Every case under one choice: `mode` "heuristic" or "measured" (with
    `limit` candidates: cudnn.benchmark_limit; None keeps PyTorch's)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = mode == "measured"
    if limit is not None:
        torch.backends.cudnn.benchmark_limit = limit
    rows = []
    for sig, calls in p2_conv_signatures().items():
        for batch in batches:
            for pas in ("fprop", "dgrad"):
                fn = _case(sig, batch, pas)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                first = 1e3 * (time.perf_counter() - t0)
                one = _ms(fn, 2)
                ms = _ms(fn, max(3, min(100, int(60 / max(one, 1e-3)))))
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                kern = collections.Counter()
                for e in prof.events():
                    if e.device_type == DeviceType.CUDA:
                        kern[e.name] += e.device_time_total
                top = max(kern, key=kern.get) if kern else ""
                rows.append({"sig": list(sig), "calls": calls, "batch": batch, "pass": pas,
                             "first_ms": first, "ms": ms, "kernel": top[:120],
                             "family": family(top)})
                print(f"{mode} {sig} b{batch} {pas}: {ms:.3f} ms ({first:.1f} ms first) "
                      f"{family(top)} {top[:80]}", file=sys.stderr, flush=True)
    return rows


def _key(limit: int | None) -> str:
    return "heuristic" if limit == 0 else "measured" if limit is None else f"limit{limit}"


def tables(res: dict, batches, limits) -> str:
    """The markdown tables of a run: `res` as conv_choice.json holds it."""
    pol = _key(res["policy_limit"])
    cols = ("heuristic", "measured", pol)
    head = f"heuristic / 10 / {res['policy_limit']}"
    out = [f"# {res['device']}, power limit {res['power_limit']}; full f32, fprop "
           "channels_last, dgrad NCHW; times in ms a call",
           "", f"| c_in -> c_out, k, H x W (calls) | batch | fprop: {head} | dgrad: {head} "
           "| first fprop / dgrad |", "|---|---|---|---|---|"]
    rows = {c: {(tuple(r["sig"]), r["batch"], r["pass"]): r for r in res[c]}
            for c in res if isinstance(res[c], list)}
    sums = collections.defaultdict(float)
    for sig, batch, pas in rows["heuristic"]:
        for c in rows:
            r = rows[c][(sig, batch, pas)]
            sums[(c, batch, pas)] += r["calls"] * r["ms"]
            sums[(c, batch, "first")] += r["first_ms"]
        if pas != "fprop":
            continue
        cin, cout, k, s, h, w = sig
        cells = [" / ".join(f"{rows[c][(sig, batch, p)]['ms']:.3f} "
                            f"{family(rows[c][(sig, batch, p)]['kernel'])}" for c in cols)
                 for p in ("fprop", "dgrad")]
        first = " / ".join(f"{rows[pol][(sig, batch, p)]['first_ms']:.0f}"
                           for p in ("fprop", "dgrad"))
        out.append(f"| {cin} -> {cout}, {k}x{k}{f'/{s}' if s != 1 else ''}, {h} x {w} "
                   f"({rows['heuristic'][(sig, batch, pas)]['calls']}) | {batch} | "
                   f"{cells[0]} | {cells[1]} | {first} |")
    out += ["", "One forward's convolutions (each signature times its calls), ms:", "",
            f"| batch | fprop {head} | dgrad {head} | first calls under "
            f"{res['policy_limit']}, s |", "|---|---|---|---|"]
    for b in batches:
        f, d = (" / ".join(f"{sums[(c, b, p)]:.1f}" for c in cols) for p in ("fprop", "dgrad"))
        out.append(f"| {b} | {f} | {d} | {sums[(pol, b, 'first')] / 1e3:.2f} |")
    out += ["", "fprop + dgrad of one forward under each number of candidates:", "",
            f"| candidates | ms at batch {' / '.join(map(str, batches))} | first calls, s "
            "| cases over 1.1x the time with 10 |", "|---|---|---|---|"]
    for n in sorted({10, res["policy_limit"], *limits}):
        c = _key(None if n == 10 else n)
        ms = " / ".join(f"{sums[(c, b, 'fprop')] + sums[(c, b, 'dgrad')]:.1f}" for b in batches)
        slow = sum(r["ms"] > 1.1 * rows["measured"][k]["ms"] for k, r in rows[c].items())
        first = sum(sums[(c, b, "first")] for b in batches) / 1e3
        out.append(f"| {n} | {ms} | {first:.1f} | {slow} |")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", type=int, nargs="+", default=[1, 3, 5, 9])
    p.add_argument("--limits", type=int, nargs="*", default=[])
    p.add_argument("--out", default=os.path.join(ROOT, "runs", "conv_choice"))
    p.add_argument("--tables", metavar="JSON", help="print the tables of a saved run")
    a = p.parse_args(argv)
    if a.tables:
        with open(a.tables) as f:
            res = json.load(f)
        batches = sorted({r["batch"] for r in res["heuristic"]})
        limits = [int(c[5:]) for c in res if c.startswith("limit")]
        print(tables({"policy_limit": policy_limit(), **res}, batches, limits))
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    os.makedirs(a.out, exist_ok=True)
    pol = policy_limit()
    res = {"device": torch.cuda.get_device_name(0),
           "power_limit": subprocess.run(
               ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
               capture_output=True, text=True).stdout.strip(),
           "policy_limit": pol}
    spawn = multiprocessing.get_context("spawn")
    for limit in dict.fromkeys([0, None, pol, *a.limits]):   # 0: the heuristic
        with ProcessPoolExecutor(1, mp_context=spawn) as one:
            res[_key(limit)] = one.submit(
                measure, "heuristic" if limit == 0 else "measured", a.batches,
                limit or None).result()
    with open(os.path.join(a.out, "conv_choice.json"), "w") as f:
        json.dump(res, f)
    print(tables(res, a.batches, a.limits))
    return 0


if __name__ == "__main__":
    sys.exit(main())

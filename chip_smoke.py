#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one card and check it.

Run from the root of a checkout, with one CUDA device:

    python3 chip_smoke.py

It exits nonzero, printing no result, without a card or outside a checkout.
Phases (any failure raises; nothing is caught and skipped):

  1. Build the CUDA kernels from loco_edit_tpu_torch/csrc (one nvcc per
     source, in parallel); print the build time and the card.
  2. Each kernel against its plain PyTorch version at every shape a P2
     forward gives it (recorded with forward pre-hooks), at batch 1 and 45,
     in f32 and bf16: max abs error against the stated tolerance, the route
     taken (attention: bf16 tensor cores or f32 FMA), the times of the
     kernel, the plain version and one PyTorch library call (F.group_norm,
     F.scaled_dot_product_attention) beside the bound and the kernel's share
     of it, each launch after the last from the host (`ms`) and, for the
     kernel and the library call, replayed from a CUDA graph (`device_ms`:
     the device alone); GroupNorm launched twice on one input must give the
     same bits.
  3. The full-width FFHQ_P2 forward in f32 and one J.v of the PMP: the card
     (kernels) against the CPU (plain versions).
  4. The flagship edit at full width, bf16 network, f32 state: invert,
     generate to 0.6T, the fused rank-5+5 basis (10 sweeps), null-space
     projection, 5 PCs x 9-frame walks, boosted denoise of all 45 frames.
  5. Kernel launch counts of phase 4 against what its number of P2 forward
     passes predicts (65 GroupNorm and 4 attention launches per forward).

The last three lines of standard output are the card's name and power limit
(nvidia-smi), the kernels' JSON line and the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
# kernel vs plain version: f32 differs by summation order; bf16 outputs are
# one bf16 rounding of nearby f32 values (two ulps at |y| <= 8 for GN, at
# |y| <= 4 for attention)
TOL = {("groupnorm", "float32"): 1e-4, ("groupnorm", "bfloat16"): 6e-2,
       ("flash_attention", "float32"): 5e-5, ("flash_attention", "bfloat16"): 3e-2}
# full-width f32 forward and J.v, card vs CPU, relative to the largest value
FWD_RTOL = 1e-3


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def cuda_ms(fn, budget_ms: float = 30.0) -> float:
    """Mean device time of fn() by CUDA events, after two warm-up calls."""
    fn()
    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    reps = int(min(50, max(3, budget_ms / max(e0.elapsed_time(e1), 1e-3))))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of fn() alone: reps calls captured in one CUDA graph and
    replayed, so no host work sits between the launches."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        g.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (3 * reps)


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from loco_edit_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.load_library()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    spills = [ln.strip() for ln in _cuda.build_log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")
              and " 0 bytes spill stores" not in ln]
    log(f"[1 build] {build_s:.1f} s for {len(_cuda._sources())} sources; card: {smi}")
    for s in spills:
        log(f"[1 build] ptxas: {s}")
    return smi


def record_p2_shapes(model):
    """Input shapes of every GroupNorm and attention call of one forward."""
    from loco_edit_tpu_torch.models.adm.unet import AttentionBlock, GroupNorm32

    gn, attn, hooks = [], [], []
    for m in model.modules():
        if isinstance(m, GroupNorm32):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a: gn.append(tuple(a[0].shape[1:]))))
        elif isinstance(m, AttentionBlock):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a: attn.append(
                    (mod.heads, a[0].shape[2] * a[0].shape[3],
                     a[0].shape[1] // mod.heads))))
    x = torch.zeros(1, 256, 256, 3, device="cuda")
    with torch.no_grad():
        model(x, 500.0)
    for h in hooks:
        h.remove()
    return gn, attn


def phase_kernels(model):

    from loco_edit_tpu_torch.ops.flash_attention import (attention_plain,
                                                         flash_attention_cuda, route)
    from loco_edit_tpu_torch.ops.groupnorm import group_norm_cuda, group_norm_plain

    gn_calls, attn_calls = record_p2_shapes(model)
    if len(gn_calls) != 65 or len(attn_calls) != 4:
        fail(f"a P2 forward made {len(gn_calls)} GroupNorm and {len(attn_calls)} "
             "attention calls, expected 65 and 4")
    g = torch.Generator("cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        for (c, h, w) in sorted(set(gn_calls)):
            for b in (1, 45):
                x = (torch.randn(b, h, w, c, device="cuda", generator=g) * 2 + 0.3)
                x = x.to(dtype).permute(0, 3, 1, 2)
                s = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
                bias = 0.1 * torch.randn(c, device="cuda", generator=g)
                y = group_norm_cuda(x, s, bias)
                same_bits = torch.equal(y, group_norm_cuda(x, s, bias))
                err = (y.float() - group_norm_plain(x, s, bias).float()).abs().max().item()
                nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
                bms, by = bound(nbytes, 8 * x.numel(), "float32")
                sl, bl = s.to(dtype), bias.to(dtype)
                rows.append(dict(
                    kernel="groupnorm", dtype=dt, shape=[b, c, h, w],
                    route="vec16-two-launch", same_bits=same_bits,
                    per_forward=gn_calls.count((c, h, w)), max_abs_err=err,
                    tol=TOL[("groupnorm", dt)],
                    ms=cuda_ms(lambda: group_norm_cuda(x, s, bias)),
                    plain_ms=cuda_ms(lambda: group_norm_plain(x, s, bias)),
                    library_ms=cuda_ms(lambda: F.group_norm(x, 32, sl, bl, 1e-5)),
                    device_ms=graph_ms(lambda: group_norm_cuda(x, s, bias)),
                    library_device_ms=graph_ms(lambda: F.group_norm(x, 32, sl, bl, 1e-5)),
                    bound_ms=bms, bound_by=by))
        for (heads, n, d) in sorted(set(attn_calls)):
            for b in (1, 45):
                q, k, v = (torch.randn(b, heads, n, d, device="cuda", generator=g)
                           .to(dtype) for _ in range(3))
                err = (flash_attention_cuda(q, k, v).float()
                       - attention_plain(q, k, v).float()).abs().max().item()
                bms, by = bound(4 * q.numel() * q.element_size(),
                                4 * b * heads * n * n * d, dt)
                rows.append(dict(
                    kernel="flash_attention", dtype=dt, shape=[b, heads, n, d],
                    route=route(dtype),
                    per_forward=attn_calls.count((heads, n, d)), max_abs_err=err,
                    tol=TOL[("flash_attention", dt)],
                    ms=cuda_ms(lambda: flash_attention_cuda(q, k, v)),
                    plain_ms=cuda_ms(lambda: attention_plain(q, k, v)),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, scale=d ** -0.5)),
                    device_ms=graph_ms(lambda: flash_attention_cuda(q, k, v)),
                    library_device_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, scale=d ** -0.5)),
                    bound_ms=bms, bound_by=by))
    for r in rows:
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"[2 kernels] {r['kernel']:15s} {r['dtype']:8s} {str(r['shape']):22s} "
            f"{r['route']:16s} x{r['per_forward']}/fwd err {r['max_abs_err']:.2e} "
            f"(tol {r['tol']:.0e}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} "
            f"library {r['library_ms']:.4f} bound {r['bound_ms']:.4f} ({r['bound_by']}) "
            f"share {r['bound_share']:.3f}; device only: kernel {r['device_ms']:.4f} "
            f"library {r['library_device_ms']:.4f}")
    bad = [r for r in rows if not r["max_abs_err"] <= r["tol"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    unstable = [r["shape"] for r in rows if r.get("same_bits") is False]
    if unstable:
        fail(f"GroupNorm gave other bits on a second launch at {unstable}")
    for name in ("groupnorm", "flash_attention"):
        for b in (1, 45):
            tot = forward_sums(rows, name, b)
            log(f"[2 kernels] {name} bf16 P2 forward at batch {b}: kernel "
                f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, library "
                f"{tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f}; bound share "
                f"{tot['bound_ms'] / tot['ms']:.3f}, kernel / library "
                f"{tot['ms'] / tot['library_ms']:.2f}; device only: kernel "
                f"{tot['device_ms']:.4f} ms, library {tot['library_device_ms']:.4f}, "
                f"bound share {tot['bound_ms'] / tot['device_ms']:.3f}, kernel / library "
                f"{tot['device_ms'] / tot['library_device_ms']:.2f}")
    return rows


def forward_sums(rows, name, batch):
    """Sums over the calls of one P2 forward in bf16 (the flagship network's
    dtype) at one batch size."""
    mine = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"
            and r["shape"][0] == batch]
    return {k: sum(r[k] * r["per_forward"] for r in mine)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                      "library_device_ms")}


def summarize(rows, name, source, replaces, launches):
    """One kernels-line entry: the sums over the calls of one P2 forward in
    bf16 at batch 1, and at batch 45 under the keys ending in _b45."""
    mine = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"
            and r["shape"][0] == 1]
    tot = forward_sums(rows, name, 1)
    b45 = forward_sums(rows, name, 45)
    by_bytes = sum(r["per_forward"] * r["bound_ms"] for r in mine
                   if r["bound_by"] == "bytes")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name and r["dtype"] == "bfloat16"),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations",
            "library_ms": tot["library_ms"],
            "device_ms": tot["device_ms"], "library_device_ms": tot["library_device_ms"],
            **{f"{k}_b45": b45[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                            "device_ms", "library_device_ms")}}


def phase_forward_vs_cpu(den):
    from loco_edit_tpu_torch.diffusion import LinspaceDDIM
    from loco_edit_tpu_torch.editing.pullback import pmp_pullback_fn
    from loco_edit_tpu_torch.models.adm import ADMUNet

    model = den.meta["model"]
    with torch.device("cpu"):
        cpu_model = ADMUNet(model.cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_model.requires_grad_(False).eval()
    sched = LinspaceDDIM()
    grid = sched.generation_grid(100)
    idx = sched.nearest_step_index(100, 0.6)
    t, ab = float(grid.t[idx]), float(grid.alpha_bar[idx])
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 256, 256, 3)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 256, 256, 3)).astype(np.float32))
    v = v / v.norm()
    out = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        t0 = time.perf_counter()
        with torch.no_grad():
            eps = m(x.to(dev), t)
        f = pmp_pullback_fn(lambda z, tt: m(z, tt), ab, t)
        jv = torch.func.jvp(f, (x.to(dev),), (v.to(dev),))[1]
        out[dev] = (eps.cpu(), jv.cpu(), time.perf_counter() - t0)
    res = {}
    for i, name in ((0, "eps"), (1, "jv")):
        a, b = out["cuda"][i], out["cpu"][i]
        if not (torch.isfinite(a).all() and a.shape == (1, 256, 256, 3)):
            fail(f"full-width {name} on the card is not finite of shape (1,256,256,3)")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        res[f"{name}_rel_err"] = rel
        res[f"{name}_max_abs"] = b.abs().max().item()
        if not rel <= FWD_RTOL:
            fail(f"full-width f32 {name}: card vs CPU relative error {rel:.2e} "
                 f"> {FWD_RTOL:.0e}")
    log(f"[3 forward] FFHQ_P2 f32 t={t:.2f}: eps rel err {res['eps_rel_err']:.2e} "
        f"(max |eps| {res['eps_max_abs']:.3f}), J.v rel err {res['jv_rel_err']:.2e} "
        f"(max |Jv| {res['jv_max_abs']:.3f}), tol {FWD_RTOL:.0e}; "
        f"forward+jvp card {out['cuda'][2]:.2f} s, CPU {out['cpu'][2]:.2f} s")


def phase_flagship(den, work_dir):
    from loco_edit_tpu_torch.core.rng import seed_everything
    from loco_edit_tpu_torch.ops.flash_attention import flash_attention_cuda
    from loco_edit_tpu_torch.ops.groupnorm import group_norm_cuda
    from loco_edit_tpu_torch.pipelines import UncondEditConfig, UncondEditPipeline

    cfg = UncondEditConfig(
        for_steps=100, inv_steps=100, edit_t=0.6, performance_boosting_t=0.2,
        x_space_guidance_scale=0.5, x_space_guidance_num_step=16, vis_num=4,
        vis_num_pc=5, pca_rank=5, pca_rank_null=5, min_iter=9, max_iter=10,
        convergence_threshold=0.0, result_folder=work_dir)
    pipe = UncondEditPipeline(den, cfg, seed_everything(0), device="cuda")
    rng = np.random.default_rng(2)
    x0 = np.clip(rng.normal(size=(1, 256, 256, 3)) * 0.5, -1, 1).astype(np.float32)
    side = int(round(256 * 0.2 ** 0.5))
    lo = (256 - side) // 2
    mask = np.zeros((1, 256, 256, 3), bool)
    mask[:, lo:lo + side, lo:lo + side, :] = True
    log(f"[4 flagship] FFHQ_P2 bf16 network, f32 state; for_steps={cfg.for_steps} "
        f"inv_steps={cfg.inv_steps} edit_t={cfg.edit_t} boost_t="
        f"{cfg.performance_boosting_t} rank {cfg.pca_rank}+{cfg.pca_rank_null} "
        f"sweeps min_iter={cfg.min_iter} max_iter={cfg.max_iter} tol=0 "
        f"num_step={cfg.x_space_guidance_num_step} vis_num={cfg.vis_num} "
        f"pcs={cfg.vis_num_pc}; mask {mask.mean():.3f} of pixels")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group_norm_cuda.launches = 0
    flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    out = pipe.run_edit_null_space_projection(x0=x0, mask=mask, sample_name="smoke")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"groupnorm": group_norm_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    vT = out["vT"]
    norms = np.linalg.norm(vT, axis=1)
    checks = {
        "xt_finite": bool(np.isfinite(out["xt"]).all()),
        "vT_shape": list(vT.shape) == [5, 256 * 256 * 3],
        "vT_finite": bool(np.isfinite(vT).all()),
        "vT_unit_norm": bool(np.abs(norms - 1).max() < 1e-4),
        "strips": sorted(out["strips"]) == list(range(5)) and all(
            s.shape == (9, 256, 256, 3) and np.isfinite(s).all()
            for s in out["strips"].values()),
    }
    phases = {k: round(v, 3) for k, v in pipe.timings.items()}
    log(f"[4 flagship] {total_s:.2f} s total; phases (s) {phases}; peak device "
        f"memory {peak_gib:.2f} GiB; checks {checks}; |vT| rows {norms.round(6).tolist()}")
    if not all(checks.values()):
        fail(f"flagship output checks failed: {checks}")

    # forwards: inversion (inv_steps - 2) + generation to edit_t (edit_t_idx)
    # + basis (one vjp primal + one jvp primal per sweep) + strip denoise
    # (the remaining for_steps - 1 - edit_t_idx steps, one batch-45 call each)
    forwards = ((cfg.inv_steps - 2) + pipe.edit_t_idx + (1 + cfg.max_iter)
                + (cfg.for_steps - 1 - pipe.edit_t_idx))
    predicted = {"groupnorm": 65 * forwards, "flash_attention": 4 * forwards}
    log(f"[5 launches] {forwards} P2 forwards; launches {launches}, predicted {predicted}")
    if launches != predicted:
        fail(f"kernel launches {launches} != predicted {predicted}: a path went "
             "around a kernel or launched it more than once per forward")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    try:
        import loco_edit_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a loco-edit-tpu checkout",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from loco_edit_tpu_torch.models.registry import load_adm_denoiser

    t_start = time.perf_counter()
    smi = phase_build()

    den32 = load_adm_denoiser("FFHQ_P2", dtype=torch.float32, device="cuda", seed=0)
    rows = phase_kernels(den32.meta["model"])
    phase_forward_vs_cpu(den32)
    del den32
    torch.cuda.empty_cache()

    den16 = load_adm_denoiser("FFHQ_P2", dtype=torch.bfloat16, device="cuda", seed=0)
    with tempfile.TemporaryDirectory() as work_dir:
        launches = phase_flagship(den16, work_dir)

    kernels = [
        summarize(rows, "groupnorm", "loco_edit_tpu_torch/csrc/groupnorm.cu",
                  "loco_edit_tpu/ops/pallas/groupnorm_stats.py:70",
                  launches["groupnorm"]),
        summarize(rows, "flash_attention", "loco_edit_tpu_torch/csrc/flash_attention.cu",
                  "loco_edit_tpu/ops/pallas/flash_attention.py:56",
                  launches["flash_attention"]),
    ]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

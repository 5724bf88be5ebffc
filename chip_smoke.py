#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main paths on one card and check them.

Run from the root of a checkout, with one CUDA device:

    python3 chip_smoke.py

It exits nonzero, printing no result, without a card or outside a checkout.
Phases (any failure raises; nothing is caught and skipped):

  1. Build the CUDA kernels from loco_edit_tpu_torch/csrc (one nvcc per
     source, in parallel); print the build time and the card.
  2. Each kernel against its plain PyTorch version at every shape a forward
     of each model gives it (recorded with forward pre-hooks): FFHQ_P2 (GN
     eps 1e-5, attention 8 heads of 64) and CelebA_HQ_HF (GN eps 1e-6,
     single-head attention at D = 512, the wide-head route), at batch 1 and
     45, in f32 and bf16: max abs error against the stated tolerance, the
     route taken, the times of the kernel, the plain version and one
     PyTorch library call (F.group_norm, F.scaled_dot_product_attention)
     beside the bound and the kernel's share of it, each launch after the
     last from the host (`ms`) and, for the kernel and the library call,
     replayed from a CUDA graph (`device_ms`: the device alone); GroupNorm
     launched twice on one input must give the same bits.
  3. The full-width FFHQ_P2 and CelebA_HQ_HF forwards in f32 and one J.v of
     the PMP each: the card (kernels) against the CPU (plain versions).
  4. The P2 flagship edit at full width, bf16 network, f32 state: invert,
     generate to 0.6T, the fused rank-5+5 basis (10 sweeps), null-space
     projection, 5 PCs x 9-frame walks, boosted denoise of all 45 frames.
  5. Kernel launch counts of phase 4 against what its number of P2 forward
     passes predicts (65 GroupNorm and 4 attention launches per forward).
  6. The CelebA_HQ_HF edit through the CLI (`cli.main.main`), bf16, over a
     seeded synthetic CelebAMask-HQ tree (one 256^2 image, ground-truth
     masks): the reference's steps (100/100, edit_t 0.6, rank 5+5, x-space
     guidance 0.5 x 16), then the group edit with the two direction files
     it wrote. Each run's launch counts must be 71 GroupNorm and 6
     attention launches per DDPM forward, its forwards what its steps
     predict; directions finite and unit-norm; PNG and .npz artifacts
     written.

Launch counts are set to 0 just before each main path (phases 4, 6 edit,
6 group) and read just after. The last three lines of standard output are
the card's name and power limit (nvidia-smi), the kernels' JSON line and
the result line.
"""

from __future__ import annotations

import json
import os
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


def record_call_shapes(model, tag):
    """Input shapes of every GroupNorm ((C, H, W)) and attention ((heads, N,
    D)) call of one forward of an ADM ("P2") or DDPM model."""
    if tag == "P2":
        from loco_edit_tpu_torch.models.adm.unet import AttentionBlock as Attn
        from loco_edit_tpu_torch.models.adm.unet import GroupNorm32 as Norm
    else:
        from loco_edit_tpu_torch.models.ddpm.unet import AttnBlock as Attn
        from loco_edit_tpu_torch.models.ddpm.unet import Norm

    gn, attn, hooks = [], [], []
    for m in model.modules():
        if isinstance(m, Norm):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a: gn.append(tuple(a[0].shape[1:]))))
        elif isinstance(m, Attn):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a: attn.append(
                    (getattr(mod, "heads", 1), a[0].shape[2] * a[0].shape[3],
                     a[0].shape[1] // getattr(mod, "heads", 1)))))
    x = torch.zeros(1, 256, 256, 3, device="cuda")
    with torch.no_grad():
        model(x, 500.0)
    for h in hooks:
        h.remove()
    return gn, attn


# per model: GN eps, GN and attention calls per forward
MODELS = {"P2": (1e-5, 65, 4), "DDPM": (1e-6, 71, 6)}


def phase_kernels(model, tag):
    from loco_edit_tpu_torch.ops.flash_attention import (attention_plain,
                                                         flash_attention_cuda, route)
    from loco_edit_tpu_torch.ops.groupnorm import group_norm_cuda, group_norm_plain

    eps, n_gn, n_attn = MODELS[tag]
    gn_calls, attn_calls = record_call_shapes(model, tag)
    if len(gn_calls) != n_gn or len(attn_calls) != n_attn:
        fail(f"a {tag} forward made {len(gn_calls)} GroupNorm and {len(attn_calls)} "
             f"attention calls, expected {n_gn} and {n_attn}")
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
                y = group_norm_cuda(x, s, bias, eps=eps)
                same_bits = torch.equal(y, group_norm_cuda(x, s, bias, eps=eps))
                err = (y.float() - group_norm_plain(x, s, bias, eps=eps).float()
                       ).abs().max().item()
                nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
                bms, by = bound(nbytes, 8 * x.numel(), "float32")
                sl, bl = s.to(dtype), bias.to(dtype)
                rows.append(dict(
                    model=tag, kernel="groupnorm", dtype=dt, shape=[b, c, h, w],
                    route="vec16-two-launch", eps=eps, same_bits=same_bits,
                    per_forward=gn_calls.count((c, h, w)), max_abs_err=err,
                    tol=TOL[("groupnorm", dt)],
                    ms=cuda_ms(lambda: group_norm_cuda(x, s, bias, eps=eps)),
                    plain_ms=cuda_ms(lambda: group_norm_plain(x, s, bias, eps=eps)),
                    library_ms=cuda_ms(lambda: F.group_norm(x, 32, sl, bl, eps)),
                    device_ms=graph_ms(lambda: group_norm_cuda(x, s, bias, eps=eps)),
                    library_device_ms=graph_ms(lambda: F.group_norm(x, 32, sl, bl, eps)),
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
                    model=tag, kernel="flash_attention", dtype=dt, shape=[b, heads, n, d],
                    route=route(dtype, d),
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
        log(f"[2 kernels] {tag:4s} {r['kernel']:15s} {r['dtype']:8s} "
            f"{str(r['shape']):22s} {r['route']:25s} x{r['per_forward']}/fwd err "
            f"{r['max_abs_err']:.2e} (tol {r['tol']:.0e}) kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} library {r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}) share {r['bound_share']:.3f}; device only: kernel "
            f"{r['device_ms']:.4f} library {r['library_device_ms']:.4f}")
    bad = [r for r in rows if not r["max_abs_err"] <= r["tol"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    unstable = [r["shape"] for r in rows if r.get("same_bits") is False]
    if unstable:
        fail(f"GroupNorm gave other bits on a second launch at {unstable}")
    for name in ("groupnorm", "flash_attention"):
        for b in (1, 45):
            tot = forward_sums(rows, name, b, tag)
            log(f"[2 kernels] {name} bf16 {tag} forward at batch {b}: kernel "
                f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, library "
                f"{tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f}; bound share "
                f"{tot['bound_ms'] / tot['ms']:.3f}, kernel / library "
                f"{tot['ms'] / tot['library_ms']:.2f}; device only: kernel "
                f"{tot['device_ms']:.4f} ms, library {tot['library_device_ms']:.4f}, "
                f"bound share {tot['bound_ms'] / tot['device_ms']:.3f}, kernel / library "
                f"{tot['device_ms'] / tot['library_device_ms']:.2f}")
    return rows


SUM_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms", "library_device_ms")


def forward_sums(rows, name, batch, tag):
    """Sums over the calls of one forward of model `tag` in bf16 (the edit
    network's dtype) at one batch size."""
    mine = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"
            and r["shape"][0] == batch and r["model"] == tag]
    return {k: sum(r[k] * r["per_forward"] for r in mine) for k in SUM_KEYS}


def summarize(rows, name, source, replaces, launches):
    """One kernels-line entry: the sums over the calls of one P2 forward in
    bf16 at batch 1 under the plain keys, at batch 45 under the keys ending
    in _b45, and the same sums of one CelebA_HQ_HF forward under keys
    starting with ddpm_. `launches` maps each main path to its count; the
    entry's `launches` is their total."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": sum(launches.values()), "launches_by_path": launches,
             "max_abs_err": max(r["max_abs_err"] for r in rows
                                if r["kernel"] == name and r["dtype"] == "bfloat16")}
    for tag, prefix in (("P2", ""), ("DDPM", "ddpm_")):
        mine = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"
                and r["shape"][0] == 1 and r["model"] == tag]
        tot = forward_sums(rows, name, 1, tag)
        b45 = forward_sums(rows, name, 45, tag)
        by_bytes = sum(r["per_forward"] * r["bound_ms"] for r in mine
                       if r["bound_by"] == "bytes")
        entry.update({f"{prefix}{k}": tot[k] for k in SUM_KEYS})
        entry[f"{prefix}bound_by"] = ("bytes" if by_bytes >= tot["bound_ms"] / 2
                                      else "operations")
        entry.update({f"{prefix}{k}_b45": b45[k] for k in SUM_KEYS})
    return entry


def phase_forward_vs_cpu(den, tag):
    from loco_edit_tpu_torch.diffusion import LinspaceDDIM
    from loco_edit_tpu_torch.editing.pullback import pmp_pullback_fn

    model = den.meta["model"]
    with torch.device("cpu"):
        cpu_model = type(model)(model.cfg)
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
            fail(f"full-width {tag} {name} on the card is not finite of shape (1,256,256,3)")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        res[f"{name}_rel_err"] = rel
        res[f"{name}_max_abs"] = b.abs().max().item()
        if not rel <= FWD_RTOL:
            fail(f"full-width f32 {tag} {name}: card vs CPU relative error {rel:.2e} "
                 f"> {FWD_RTOL:.0e}")
    log(f"[3 forward] {tag} f32 t={t:.2f}: eps rel err {res['eps_rel_err']:.2e} "
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


def write_celeba_tree(root, size=256, seed=3):
    """A seeded synthetic CelebAMask-HQ tree: CelebA-HQ-img/0.jpg and binary
    ellipse masks CelebAMask-HQ-mask-anno/0/00000_{sem}.png."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "CelebA-HQ-img")
    anno = os.path.join(root, "CelebAMask-HQ-mask-anno", "0")
    os.makedirs(img_dir)
    os.makedirs(anno)
    yy, xx = np.mgrid[:size, :size] / size
    img = (rng.uniform(0, 1, (size, size, 3)) * 60
           + 160 * np.stack([yy, xx, 1 - yy], -1)).astype(np.uint8)
    Image.fromarray(img).save(os.path.join(img_dir, "0.jpg"))
    for sem, (cy, cx, ry, rx) in {"skin": (0.5, 0.5, 0.35, 0.28),
                                  "hair": (0.2, 0.5, 0.18, 0.4),
                                  "l_eye": (0.42, 0.38, 0.04, 0.07),
                                  "mouth": (0.7, 0.5, 0.05, 0.12)}.items():
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        Image.fromarray(m.astype(np.uint8) * 255).save(
            os.path.join(anno, f"00000_{sem}.png"))
    return root


class ForwardCounter:
    """Counts forward calls of one module class (a global forward pre-hook;
    transforms such as vmap and jvp run a forward once per call)."""

    def __init__(self, cls):
        self.cls, self.calls = cls, 0

    def _hook(self, mod, args):
        if isinstance(mod, self.cls):
            self.calls += 1

    def __enter__(self):
        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(self._hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def run_main_path(fn, model_cls):
    """fn() with the kernels' launch counts set to 0 just before and read
    just after, the forwards of model_cls counted, the peak device memory
    and the wall time taken."""
    from loco_edit_tpu_torch.ops.flash_attention import flash_attention_cuda
    from loco_edit_tpu_torch.ops.groupnorm import group_norm_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ForwardCounter(model_cls) as fwd:
        group_norm_cuda.launches = 0
        flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {"groupnorm": group_norm_cuda.launches,
                    "flash_attention": flash_attention_cuda.launches}
    return out, launches, fwd.calls, total_s, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_ddpm_cli(work_dir):
    """The CelebA_HQ_HF edit and group edit through the CLI. Returns the
    launch counts of each run."""
    from loco_edit_tpu_torch.cli.main import main as cli_main
    from loco_edit_tpu_torch.models.ddpm import DDPMUNet

    tree = write_celeba_tree(os.path.join(work_dir, "celeba"))
    steps, edit_t = 100, 0.6
    argv = ["--model_name", "CelebA_HQ_HF", "--dtype", "bf16", "--device", "cuda",
            "--dataset_name", "CelebA_HQ_mask", "--dataset_root", tree,
            "--sample_idx", "0", "--choose_sem", "hair", "--use_mask", "true",
            "--for_steps", str(steps), "--inv_steps", str(steps),
            "--edit_t", str(edit_t), "--performance_boosting_t", "0.2",
            "--use_x_space_guidance", "true", "--x_space_guidance_scale", "0.5",
            "--x_space_guidance_edit_step", "1", "--x_space_guidance_num_step", "16",
            "--vis_num", "4", "--pca_rank", "5", "--pca_rank_null", "5",
            "--null_space_projection", "true", "--seed", "1",
            "--result_folder", os.path.join(work_dir, "runs")]
    log(f"[6 ddpm cli] python -m loco_edit_tpu_torch.cli.main {' '.join(argv)} "
        "--run_edit_null_space_projection true")
    res, launches, fwd, total_s, peak = run_main_path(
        lambda: cli_main(argv + ["--run_edit_null_space_projection", "true"]), DDPMUNet)
    out = res["edit"]
    t_idx = out["edit_t_idx"]
    fixed = (steps - 2) + t_idx + (steps - 1 - t_idx)   # invert + generate + strips
    sweeps = fwd - fixed - 1                             # basis: 1 + one per sweep
    vT = out["vT"]
    norms = np.linalg.norm(vT, axis=1)
    basis = os.path.join(out["out_dir"], "basis", f"local_basis-{edit_t}T")
    files = sorted(os.listdir(basis)) + sorted(os.listdir(out["out_dir"]))
    checks = {
        "xt_finite": bool(np.isfinite(out["xt"]).all()),
        "vT_shape": list(vT.shape) == [5, 256 * 256 * 3],
        "vT_finite": bool(np.isfinite(vT).all()),
        "vT_unit_norm": bool(np.abs(norms - 1).max() < 1e-4),
        "strips": sorted(out["strips"]) == list(range(5)) and all(
            s.shape == (9, 256, 256, 3) and np.isfinite(s).all()
            for s in out["strips"].values()),
        "pngs": sum(f.startswith("edit-") and f.endswith(".png") for f in files) == 5,
        "npz": all(f"pc_{i:03d}-vT.npz" in files for i in range(5))
        and sum(f.startswith("vT-") and f.endswith(".npz") for f in files) == 2,
        "sweeps_in_range": 10 <= sweeps <= 50,   # UncondEditConfig min/max_iter
    }
    phases = {k: round(v, 3) for k, v in res["timings"]["edit"].items()}
    log(f"[6 ddpm cli] edit: {total_s:.2f} s total (model build and dataset "
        f"included); phases (s) {phases}; peak device memory {peak:.2f} GiB; "
        f"{fwd} DDPM forwards ({sweeps} basis sweeps); launches {launches}; "
        f"checks {checks}; |vT| rows {norms.round(6).tolist()}")
    if not all(checks.values()):
        fail(f"DDPM CLI edit checks failed: {checks}")
    predicted = {"groupnorm": 71 * fwd, "flash_attention": 6 * fwd}
    if launches != predicted:
        fail(f"DDPM CLI edit launches {launches} != predicted {predicted}: a path "
             "went around a kernel or launched it more than once per forward")

    group_argv = argv + ["--group_edit_null_space_projection", "true",
                         "--vT_path", os.path.join(basis, "pc_000-vT.npz"),
                         "--vT1_path", os.path.join(basis, "pc_001-vT.npz")]
    res, g_launches, g_fwd, g_total_s, g_peak = run_main_path(
        lambda: cli_main(group_argv), DDPMUNet)
    frames = res["group"]
    png = os.path.join(out["out_dir"], "group_edit.png")
    g_checks = {"frames": frames.shape == (3, 256, 256, 3) and bool(np.isfinite(frames).all()),
                "png": os.path.exists(png), "forwards": g_fwd == fixed}
    phases = {k: round(v, 3) for k, v in res["timings"]["group"].items()}
    log(f"[6 ddpm cli] group edit: {g_total_s:.2f} s total (model build, dataset "
        f"and inversion included); phases (s) {phases}; peak device memory "
        f"{g_peak:.2f} GiB; {g_fwd} DDPM forwards (predicted {fixed}); launches "
        f"{g_launches}; checks {g_checks}")
    if not all(g_checks.values()):
        fail(f"DDPM CLI group edit checks failed: {g_checks}")
    g_predicted = {"groupnorm": 71 * fixed, "flash_attention": 6 * fixed}
    if g_launches != g_predicted:
        fail(f"DDPM CLI group edit launches {g_launches} != predicted {g_predicted}")
    return launches, g_launches


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
    from loco_edit_tpu_torch.models.ddpm import load_ddpm_denoiser
    from loco_edit_tpu_torch.models.registry import load_adm_denoiser

    t_start = time.perf_counter()
    smi = phase_build()

    den32 = load_adm_denoiser("FFHQ_P2", dtype=torch.float32, device="cuda", seed=0)
    rows = phase_kernels(den32.meta["model"], "P2")
    phase_forward_vs_cpu(den32, "FFHQ_P2")
    del den32
    ddpm32 = load_ddpm_denoiser("CelebA_HQ_HF", dtype=torch.float32, device="cuda", seed=0)
    rows += phase_kernels(ddpm32.meta["model"], "DDPM")
    phase_forward_vs_cpu(ddpm32, "CelebA_HQ_HF")
    del ddpm32
    torch.cuda.empty_cache()

    den16 = load_adm_denoiser("FFHQ_P2", dtype=torch.bfloat16, device="cuda", seed=0)
    with tempfile.TemporaryDirectory() as work_dir:
        p2_launches = phase_flagship(den16, work_dir)
    del den16
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        edit_launches, group_launches = phase_ddpm_cli(work_dir)

    paths = {"p2_flagship": p2_launches, "ddpm_cli_edit": edit_launches,
             "ddpm_cli_group_edit": group_launches}
    kernels = [
        summarize(rows, "groupnorm", "loco_edit_tpu_torch/csrc/groupnorm.cu",
                  "loco_edit_tpu/ops/pallas/groupnorm_stats.py:70",
                  {k: v["groupnorm"] for k, v in paths.items()}),
        summarize(rows, "flash_attention", "loco_edit_tpu_torch/csrc/flash_attention.cu",
                  "loco_edit_tpu/ops/pallas/flash_attention.py:56",
                  {k: v["flash_attention"] for k, v in paths.items()}),
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

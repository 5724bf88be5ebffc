#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main paths on one card and check them.

Run from the root of a checkout, with one CUDA device:

    python3 chip_smoke.py

It exits nonzero, printing no result, without a card or outside a checkout.
`python3 chip_smoke.py --conv_route` runs phases 1 and 16 alone.
`python3 chip_smoke.py --ranks N` runs phases 1 and 15 alone over N ranks,
one a card (NCCL) on a host with N cards: the transport that gloo on one
card does not use (all_gather and send/recv on the card).
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
     launched twice on one input must give the same bits; for attention,
     the plain version with the last key tile skipped, or the logits scaled
     by ATTN_MUTANT_SCALE, and in f32 the plain version on TF32-rounded
     operands (a 1xTF32 kernel), must miss the tolerance (a check of the
     check). The f32 attention route is 3xTF32 on the tensor cores; its
     bound is taken at 495 / 3 TFLOP/s. Per-forward sums are printed for
     bf16 and f32.
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

  7. Stable Diffusion 2.1-base (seeded random weights, the fake prompt
     encoder: the repo holds no SD weights or CLIP files). Phase 2's checks
     at every call shape of one U-Net forward at batch 2 (CFG; cross-
     attention at N_kv = 77, f32 GroupNorm at C = 2560), one VAE decode and
     one VAE encode at 512 px; phase 3's at the U-Net eps (batch 1, a seeded
     77 x 1024 context) and decode(PMP(z)) J.v at 512 px; then the bf16
     U-Net and decoder on the same weights: eps and decode(PMP(z)) against
     the f32 CPU within a relative L2 error of BF16_FWD_RTOL.
  8. The SD edit through the CLI, bf16, full width and depth, over a box
     mask.npz it writes: rank 5+5 dual basis through the 512 px decoder,
     null-space projection, 5 PCs x 9-frame walks, chunked denoise and
     decode. Cuts, printed with the phase: 20/20 steps (not 100) and a fixed
     5 basis sweeps (min_iter = max_iter = 5). Then, from Python on the same
     pipeline, the text-supervised direction (delta_zt_via_grad) and the
     inversion of a seeded 512 px image through the encoder. Each run's
     launches must be 61 GN + 32 attention per U-Net forward, 30 + 1 per
     decode and 22 + 1 per encode, its forwards what its steps predict.

  9. LCM Dreamshaper v7 (the SD 1.5 U-Net, 8 heads of 40, 80 and 160, with
     the guidance embedding cond_proj; seeded random weights, the 768-wide
     fake prompt encoder). Phase 2's checks at every call shape of one
     U-Net forward at batch 1 (generate, the basis primal, the text
     direction) and 3 (the strip); the f32 eps against the CPU, with the
     relative error of every top-level block's output and of the first D =
     40 transformer's submodules (forward hooks), and the bf16 eps against
     the f32 CPU. Then the LCM edit through the CLI, bf16, at the reference
     script's settings (4 steps, edit_t_idx 2, guidance 7.5, non-semantic
     rank 5+5 dual basis through the 512 px decoder, null-space projection,
     x-space guidance 0.4 x 24, vis_num 1), its mask from a first
     --sampling_mode true run of the same command with --mask_backend flax
     (the generated 512 px image through SAM ViT-L with seeded weights;
     (n, 512, 512, 3) masks and overlays), the edit reading --mask_index 0;
     cut, printed with the phase: a fixed 5 basis sweeps. Then
     delta_zt_via_grad from Python. Then the same command at the script's
     own --dtype fp32 (the f32 routes: 3xTF32 attention at D = 40, 80, 160),
     reading the bf16 run's cached mask, LCM_F32_SWEEPS fixed sweeps; its
     phase seconds, peak memory and launches printed. Launches: 61 GN + 32
     attention per U-Net forward, 30 + 1 per decode; forwards what the steps
     predict.
 10. DeepFloyd-IF: seeded diffusers-named IF-I-M and IF-II-M state_dicts
     written to .pt files and loaded through the CLI's registry
     (infer_if_config and the converter at full width). Phase 2's checks at
     every IF-I-M call shape at the CFG batch 2 (added-KV attention at N_kv
     = 77 + N_q, GN over the (77, 512) text states) and every IF-II-M one at
     batch 10; the IF-I-M eps checks as in phase 9. Then the semantic IF
     edit through the CLI at the reference script's settings (100 steps,
     edit_t 0.75, (for-edit)-direct, rank 1 + null 5) with the DiffEdit
     mask, bf16, and the IF-II-M upscale of its strip. Launches: 117 GN + 22
     attention per IF-I-M forward, 89 + 8 per IF-II-M forward.
 11. SAM at facebook/sam-vit-large's geometry (seeded weights of HF's init
     distribution): the parameter count; the f32 encoder embedding and one
     64-point decode batch (logits, IoU) on the card against the CPU; the
     automatic masks of a seeded 512 px image, timed (encode, decode a
     batch, host filters and NMS, masks kept). SAM reaches no kernel.
 12. scripts/main_hf_null_space_projection_FFHQ_P2.sh through the CLI, f32,
     with every flag it passes (100/100 steps, edit_t 0.2, rank 3 + null 5,
     x-space guidance 12 x 1, vis_num 2) plus --device cuda, a seeded
     one-image FFHQ folder, --result_folder and --mask_backend flax: the
     --sampling_mode true run (SAM masks + overlays, exit 0), then the edit
     with --mask_index 0. Launches: 65 GN + 4 attention per P2 forward (the
     f32 routes); forwards what the steps predict; unit-norm finite
     directions, strips and artifacts. Cut, printed with the phase: a fixed
     5 sweeps a basis (the script's CLI: 10-50 until 1e-3).
 13. The port's edit server (serve.py: EditService behind make_server on
     127.0.0.1, port 0, in a thread), over HTTP. FFHQ_P2 at full width,
     bf16, 100/100 steps, rank 5 + null 5, 10 fixed sweeps: /health; /edit
     with a seed and a mask_bbox (uint8); the same request again (the
     cached basis: the same bits); /edit_batch of two seeds and an image,
     each item held to its own /edit within BF16_FWD_RTOL (relative L2);
     /invert, the same bits as pipe.invert; /segment with seeded SAM ViT-L
     at 256 px; one /edit under utils/logger.py::device_trace, whose trace
     gives the device's busy share of the request's window; then SSIM,
     masked MSE and LPIPS (alex, a seeded state_dict it writes) of a served
     strip against its original, card vs CPU. LCM Dreamshaper v7 at full
     width, bf16, 4 steps, 5 fixed sweeps: /edit with "pixel" true and the
     same request with "pixel" false; the uint8 strip must equal to_uint8
     of the float strip. Each request's host seconds, server secs,
     edits_served and peak memory printed; its forwards and launches held
     to its steps. At the end of phase 10, `--verify_load all` over its
     IF-I-M and IF-II-M checkpoints and a seeded LPIPS file: every file
     classified, converted with full key coverage, finite on the card.
 14. Training and the rest of the toolkit on FFHQ_P2 at full width
     (93,563,910 parameters, seeded). One f32 train step at batch 1, card
     (kernels) vs CPU (plain versions), the same injected noise, full f32:
     loss, grad_norm and the input_0, middle and out_conv gradients held to
     FWD_RTOL. run_training in bf16 with f32 masters over ShardedImageLoader
     (16 seeded 256 px images; the native decoder or PIL, printed): batch 8
     in 2 microbatches, loss-aware timesteps, 10 steps and a checkpoint,
     then a resumed call to step 20; step times, images/s, peak memory,
     first and last loss, launches per step held to 2 x (65 GN + 4
     attention) (the backward rules launch none). The h-space toolkit at
     0.6 T: encoder pullback (rank 5, 10 fixed sweeps), h_to_e and inv_jac
     on its directions, global PCA over 32 draws in chunks of 8, local PCA
     over 64 probes. calc_bpd_loop with the learned sigma over a 100-step
     respaced schedule (the cut, printed), p_sample_scan at batch 4 over
     the same steps, unguided and with classifier guidance from a seeded
     EncoderADMUNet on P2's trunk (attention pool), one SuperResADMUNet
     forward with doubled input channels. Outputs finite, unit-norm rows.
 15. The mesh and parallel modules on FFHQ_P2 at full width, in two ranks
     spawned on the one card (torch.distributed over gloo: NCCL takes one
     rank a card), each join under P15_TIMEOUT_S, each held to the same
     paths in this process: two f32 data-parallel train steps at 4 rows a
     rank (one process: 8; the same global batch, timesteps and noise from
     one RngStream): loss, grad_norm and the parameter checksum to 1e-4;
     four bf16 data-parallel steps on a fixed batch, whose loss must fall;
     the f32 rank 5+5 basis, 5 fixed sweeps, probes split over the ranks:
     mean squared principal cosine >= 0.999 a group; 8 f32 strip frames
     from edit_t P15_STRIP_EDIT_T (25 of 100 steps), split 4 + 4
     (the boosted tail's noise drawn for all 8 and sliced): relative L2
     within FWD_RTOL, and a planted fault (each share given its
     neighbour's rows of that noise, in this process) must miss FWD_RTOL;
     the f32 forward and one J.v at batch 1 with the rows split over the
     ranks: FWD_RTOL. The split path must
     launch GroupNorm's statistics and normalize entries and no fused one.
     Each rank prints its backend, device and launches. Phase 2 gains the
     rows of that split path: GroupNorm's two entries at every P2 shape at
     half height (f32, bf16), sums -> apply holding the fused entry's bits
     at full height, and attention with the local queries against all keys.

TF32: the kernel-vs-plain and card-vs-CPU checks (phases 2, 3 and those of
7, 9, 10, 11 and 14) run with TF32 off for matmuls and convolutions, and phases
3, 7 and 11 also print their errors with TF32 convolutions (PyTorch's
default); the CLI and edit phases run under the backend flags the port
itself sets (its f32 entry points turn TF32 off: core/device.py).

Launch counts are set to 0 just before each main path (phases 4, 6 edit,
6 group, 8 edit, 8 delta, 8 invert, 9 edit, 9 delta, 9 f32 edit, 10 edit,
12 edit, each request of 13, 14's training, h-space and likelihood /
sampling runs, and each path of 15 in each rank) and read just after;
phase 13's sum per server is the kernels line's serve_p2 and serve_lcm,
phase 14's runs are train_p2, hspace_p2 and bpd_ancestral_p2, phase 15's
the p15_* paths summed over the ranks (the GroupNorm split entries have
entries of their own). The last three lines of standard output are the card's name and
power limit (nvidia-smi), the kernels' JSON line and the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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
              # the fastest f32-accurate product: TF32 tensor cores (495e12)
              # at three MMAs a product (3xTF32, the f32 attention route);
              # at 67e12 (f32 FMA) a correct kernel would read over 100 %
              "float32": 495e12 / 3,
              "float32_fma": 67e12}  # f32 outside the tensor cores (GroupNorm)
# kernel vs plain version: f32 differs by summation order; bf16 outputs are
# one bf16 rounding of nearby f32 values (two ulps at |y| <= 8 for GN)
TOL = {("groupnorm", "float32"): 1e-4, ("groupnorm", "bfloat16"): 6e-2,
       ("flash_attention", "float32"): 5e-5}
# f32 attention: 5e-5, tightened to 2^-13 of the largest |output| where that
# is smaller: at 4096 keys (max |y| ~ 0.1) one TF32 rounding of the operands
# (a 1xTF32 kernel, the "tf32" mutant) lands ~4e-4 of the output off, under
# 5e-5; the 3xTF32 kernel stays near 1e-5 of it (tests/test_torch_attention_f32.py)
ATTN_F32_SHARE = 2 ** -13
# bf16 attention: two bf16 ulps of the largest |output| (2^-6 of it; the
# kernel rounds P before normalizing, the plain version after: within one
# ulp in the CPU model of tests/test_torch_ops.py), never above the 3e-2 of
# the first checks. Outputs shrink with the keys averaged (max |y| ~ 0.15 at
# 4096 keys), so no absolute floor.
ATTN_BF16_ULPS, ATTN_BF16_CAP = 2 ** -6, 3e-2
# a kernel that skipped the last key tile (64 keys up to D = 128, 32 above)
# or scaled the logits by this factor must miss the tolerance
ATTN_MUTANT_SCALE = 1.03
# full-width f32 forward and J.v, card vs CPU, relative to the largest value
FWD_RTOL = 1e-3
# parameter counts of the full-width models (jax.eval_shape on the JAX
# presets; tests/test_torch_if_models.py holds both packages to them)
LCM_UNET_PARAMS = 859_602_884
IF_I_M_PARAMS, IF_II_M_PARAMS = 426_944_518, 412_539_270
# SAM at facebook/sam-vit-large's geometry: encoder and decoder parameters
# (jax.eval_shape on the JAX presets; tests/test_torch_sam.py)
SAM_ENCODER_PARAMS, SAM_DECODER_PARAMS = 308_278_272, 4_064_816
# full-width bf16 SD eps and decode(PMP(z)) on the card against the f32 CPU:
# relative L2 error (bf16 keeps 8 significant bits; ~1e-2 through the tiny
# networks on the CPU, tests/test_torch_sd_models.py)
BF16_FWD_RTOL = 5e-2


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


@contextlib.contextmanager
def tf32_convs(allowed: bool):
    """cuDNN convolutions with TF32 allowed or not, cuBLAS matmuls in full
    f32 either way (PyTorch's default for both is convolutions in TF32,
    matmuls not), the flags restored after. The kernel-vs-plain and
    card-vs-CPU checks run with it off: their references compute in full
    f32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


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
    """(C, H, W, eps) of every GroupNorm and (heads, N_q, N_kv, D) of every
    attention call of one forward of an ADM ("P2") or DDPM model."""
    if tag == "P2":
        from loco_edit_tpu_torch.models.adm.unet import AttentionBlock as Attn
        from loco_edit_tpu_torch.models.adm.unet import GroupNorm32 as Norm
    else:
        from loco_edit_tpu_torch.models.ddpm.unet import AttnBlock as Attn
        from loco_edit_tpu_torch.models.ddpm.unet import Norm

    eps = MODELS[tag][0]
    gn, attn, hooks = [], [], []
    for m in model.modules():
        if isinstance(m, Norm):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a: gn.append(tuple(a[0].shape[1:]) + (eps,))))
        elif isinstance(m, Attn):
            def rec(mod, a):
                heads, n = getattr(mod, "heads", 1), a[0].shape[2] * a[0].shape[3]
                attn.append((heads, n, n, a[0].shape[1] // heads))
            hooks.append(m.register_forward_pre_hook(rec))
    x = torch.zeros(1, 256, 256, 3, device="cuda")
    with torch.no_grad():
        model(x, 500.0)
    for h in hooks:
        h.remove()
    return gn, attn


def record_t2i_call_shapes(model, *args):
    """(GN calls (C, H, W, eps), attention calls (heads, N_q, N_kv, D)) of
    one forward of an SD, LCM or IF U-Net or an SD VAE half, recorded with
    forward pre-hooks (IF's norm_cross is a GN call of shape (C, 1, 77);
    its added-KV attention has N_kv = 77 + N_q)."""
    from loco_edit_tpu_torch.models.ifm.unet import IFAttention
    from loco_edit_tpu_torch.models.sd.unet import CrossAttention, GroupNormF32
    from loco_edit_tpu_torch.models.sd.vae import VAEAttention

    gn, attn, hooks = [], [], []

    def rec_xattn(mod, a, kw):
        x, ctx = a[0], (a[1] if len(a) > 1 else kw.get("context"))
        n_kv = x.shape[1] if ctx is None else ctx.shape[1]
        attn.append((mod.heads, x.shape[1], n_kv, x.shape[2] // mod.heads))

    def rec_vae(mod, a):
        n = a[0].shape[2] * a[0].shape[3]
        attn.append((1, n, n, a[0].shape[1]))

    def rec_if(mod, a):
        n = a[0].shape[2] * a[0].shape[3]
        attn.append((mod.heads, n, a[1].shape[1] + n, a[0].shape[1] // mod.heads))

    for m in model.modules():
        if isinstance(m, GroupNormF32):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a: gn.append(tuple(a[0].shape[1:]) + (mod.eps,))))
        elif isinstance(m, CrossAttention):
            hooks.append(m.register_forward_pre_hook(rec_xattn, with_kwargs=True))
        elif isinstance(m, VAEAttention):
            hooks.append(m.register_forward_pre_hook(rec_vae))
        elif isinstance(m, IFAttention):
            hooks.append(m.register_forward_pre_hook(rec_if))
    with torch.no_grad():
        model(*args)
    for h in hooks:
        h.remove()
    return gn, attn


def record_sd_call_shapes(models):
    """{"SD-UNet", "SD-decode", "SD-encode"} -> the GN and attention calls of
    one forward each of the SD bundle's models."""
    z = torch.zeros(1, 64, 64, 4, device="cuda")
    return {"SD-UNet": record_t2i_call_shapes(
                models["unet"], z, 500.0, torch.zeros(1, 77, 1024, device="cuda")),
            "SD-decode": record_t2i_call_shapes(models["decoder"], z),
            "SD-encode": record_t2i_call_shapes(
                models["encoder"], torch.zeros(1, 512, 512, 3, device="cuda"))}


# items of phase 13's P2 /edit_batch: its generation runs at this batch
SERVE_P2_ITEMS = 3
# per model: GN eps, GN and attention calls per forward, batch sizes timed:
# the batches the main paths give the kernels (main() fails on a launch at
# a shape no row checked). P2 runs batch 1 in generate, the inversion, the
# basis primal, the h-space toolkit and the likelihood, SERVE_P2_ITEMS in
# the served /edit_batch's generation, 4 in a training microbatch and in
# ancestral sampling (the encoder too), 8 in a global-PCA chunk, 9 in phase
# 12's f32 strip, 45 in the strips, 64 in local PCA's probes; DDPM 3 in the group edit;
# the SD U-Net 1 without CFG, 2 with it, 3 with three prompt stacks, 10 in
# the strip (5 frames x CFG 2); LCM 1 in generate, the basis primal and
# the text direction, 3 in the strip; the VAE decoder 1 in the bases, 3 in
# the LCM strip, 5 in the SD strip (memory_bound 5); IF-I-M the CFG batch
# 2, 10 and 20 in its strips; the IF-II-M upscaler 5 frames x CFG 2
MODELS = {"P2": (1e-5, 65, 4, (1, SERVE_P2_ITEMS, 4, 8, 9, 45, 64)),
          "DDPM": (1e-6, 71, 6, (1, 3, 45)),
          "SD-UNet": (None, 61, 32, (1, 2, 3, 10)), "SD-decode": (None, 30, 1, (1, 3, 5)),
          "SD-encode": (None, 22, 1, (1,)), "LCM-UNet": (None, 61, 32, (1, 3)),
          "IF-I-M": (None, 117, 22, (2, 10, 20)), "IF-II-M": (None, 89, 8, (10,))}


def gn_row(tag, dtype, b, shape, per_forward, g):
    from loco_edit_tpu_torch.ops.groupnorm import group_norm_cuda, group_norm_plain

    c, h, w, eps = shape
    dt = str(dtype).split(".")[1]
    x = (torch.randn(b, h, w, c, device="cuda", generator=g) * 2 + 0.3)
    x = x.to(dtype).permute(0, 3, 1, 2)
    s = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    bias = 0.1 * torch.randn(c, device="cuda", generator=g)
    y = group_norm_cuda(x, s, bias, eps=eps)
    same_bits = torch.equal(y, group_norm_cuda(x, s, bias, eps=eps))
    err = (y.float() - group_norm_plain(x, s, bias, eps=eps).float()).abs().max().item()
    nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
    bms, by = bound(nbytes, 8 * x.numel(), "float32_fma")
    sl, bl = s.to(dtype), bias.to(dtype)
    return dict(
        model=tag, kernel="groupnorm", dtype=dt, shape=[b, c, h, w],
        route="vec16-two-launch", eps=eps, same_bits=same_bits,
        per_forward=per_forward, max_abs_err=err, tol=TOL[("groupnorm", dt)],
        ms=cuda_ms(lambda: group_norm_cuda(x, s, bias, eps=eps)),
        plain_ms=cuda_ms(lambda: group_norm_plain(x, s, bias, eps=eps)),
        library_ms=cuda_ms(lambda: F.group_norm(x, 32, sl, bl, eps)),
        device_ms=graph_ms(lambda: group_norm_cuda(x, s, bias, eps=eps)),
        library_device_ms=graph_ms(lambda: F.group_norm(x, 32, sl, bl, eps)),
        bound_ms=bms, bound_by=by)


def tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away: what
    cvt.rna.tf32.f32 gives), by bit masking."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def attn_mutant_errs(q, k, v, tile, tf32=False):
    """How far broken kernels would land from the plain version, in f32 on
    the same inputs: one that skipped the last key tile (where there are
    two or more), one that scaled the logits by ATTN_MUTANT_SCALE and, with
    tf32, one TF32 product (the plain version on TF32-rounded q * s, k * s,
    v and P: a 1xTF32 kernel)."""
    from loco_edit_tpu_torch.ops.flash_attention import _scale, attention_plain

    q, k, v = q.float(), k.float(), v.float()
    ref = attention_plain(q, k, v)
    errs = {"scale": (attention_plain(q * ATTN_MUTANT_SCALE, k, v) - ref).abs().max().item()}
    n_kv = k.shape[2]
    if n_kv > tile:
        keep = n_kv - ((n_kv - 1) % tile + 1)
        errs["drop_tile"] = (attention_plain(q, k[:, :, :keep], v[:, :, :keep])
                             - ref).abs().max().item()
    if tf32:
        s = _scale(q.shape[-1])
        logits = torch.matmul(tf32_rna(q * s), tf32_rna(k * s).transpose(-1, -2))
        out = torch.matmul(tf32_rna(torch.softmax(logits, dim=-1)), tf32_rna(v))
        errs["tf32"] = (out - ref).abs().max().item()
    return errs


def attn_row(tag, dtype, b, shape, per_forward, g):
    from loco_edit_tpu_torch.ops.flash_attention import (attention_plain,
                                                         flash_attention_cuda,
                                                         kernel_geometry, route)

    heads, nq, nkv, d = shape
    dt = str(dtype).split(".")[1]
    q = torch.randn(b, heads, nq, d, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(b, heads, nkv, d, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    ref = attention_plain(q, k, v).float()
    out = flash_attention_cuda(q, k, v).float()
    err = (out - ref).abs().max().item()
    f32 = dtype == torch.float32
    top = ref.abs().max().item()
    tol = (min(TOL[("flash_attention", dt)], ATTN_F32_SHARE * top) if f32
           else min(ATTN_BF16_CAP, ATTN_BF16_ULPS * top))
    mutants = attn_mutant_errs(q, k, v, kernel_geometry(d, dtype).block_k, tf32=f32)
    bms, by = bound(2 * b * heads * (nq + nkv) * d * q.element_size(),
                    4 * b * heads * nq * nkv * d, dt)
    extra = {}
    if f32:   # the kernel's and the plain version's error against float64
        s64 = d ** -0.25
        r64 = torch.matmul(torch.softmax(torch.matmul(q.double() * s64, (k.double() * s64)
                                                      .transpose(-1, -2)), dim=-1), v.double())
        top64 = r64.abs().max().item()
        extra = {"f64_rel_err": (out.double() - r64).abs().max().item() / top64,
                 "plain_f64_rel_err": (ref.double() - r64).abs().max().item() / top64}
        del r64
    del out
    return dict(
        model=tag, kernel="flash_attention", dtype=dt, shape=[b, heads, nq, nkv, d],
        route=route(dtype, d), per_forward=per_forward, max_abs_err=err, tol=tol,
        mutant_errs=mutants, **extra,
        ms=cuda_ms(lambda: flash_attention_cuda(q, k, v)),
        plain_ms=cuda_ms(lambda: attention_plain(q, k, v)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=d ** -0.5)),
        device_ms=graph_ms(lambda: flash_attention_cuda(q, k, v)),
        library_device_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=d ** -0.5)),
        bound_ms=bms, bound_by=by)


def kernel_rows(tag, gn_calls, attn_calls):
    """Every distinct GN and attention call of one forward of model `tag`,
    in f32 and bf16, at its batch sizes: checked against the plain
    version, timed, printed; the per-forward sums printed."""
    _, n_gn, n_attn, batches = MODELS[tag]
    if len(gn_calls) != n_gn or len(attn_calls) != n_attn:
        fail(f"a {tag} forward made {len(gn_calls)} GroupNorm and {len(attn_calls)} "
             f"attention calls, expected {n_gn} and {n_attn}")
    g = torch.Generator("cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in sorted(set(gn_calls)):
            for b in batches:
                rows.append(gn_row(tag, dtype, b, shape, gn_calls.count(shape), g))
        for shape in sorted(set(attn_calls)):
            for b in batches:
                rows.append(attn_row(tag, dtype, b, shape, attn_calls.count(shape), g))
    for r in rows:
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"[2 kernels] {tag:9s} {r['kernel']:15s} {r['dtype']:8s} "
            f"{str(r['shape']):25s} {r['route']:25s} x{r['per_forward']}/fwd err "
            f"{r['max_abs_err']:.2e} (tol {r['tol']:.2e}"
            + "".join(f", {k} mutant {e:.2e}" for k, e in r.get("mutant_errs", {}).items())
            + f") kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} library {r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}) share {r['bound_share']:.3f}; device only: kernel "
            f"{r['device_ms']:.4f} library {r['library_device_ms']:.4f}"
            + (f"; vs float64 (relative to max |y|): kernel {r['f64_rel_err']:.2e}, plain "
               f"{r['plain_f64_rel_err']:.2e}" if "f64_rel_err" in r else ""))
    bad = [r for r in rows if not r["max_abs_err"] <= r["tol"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    blind = [r for r in rows if not all(e > r["tol"] for e in r.get("mutant_errs", {}).values())]
    if blind:
        fail(f"attention tolerance would pass a broken kernel: {blind}")
    unstable = [r["shape"] for r in rows if r.get("same_bits") is False]
    if unstable:
        fail(f"GroupNorm gave other bits on a second launch at {unstable}")
    for name, dt in (("groupnorm", "bfloat16"), ("flash_attention", "bfloat16"),
                     ("groupnorm", "float32"), ("flash_attention", "float32")):
        for b in batches:
            tot = forward_sums(rows, name, b, tag, dt)
            log(f"[2 kernels] {name} {dt} {tag} forward at batch {b}: kernel "
                f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, library "
                f"{tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f}; bound share "
                f"{tot['bound_ms'] / tot['ms']:.3f}, kernel / library "
                f"{tot['ms'] / tot['library_ms']:.2f}; device only: kernel "
                f"{tot['device_ms']:.4f} ms, library {tot['library_device_ms']:.4f}, "
                f"bound share {tot['bound_ms'] / tot['device_ms']:.3f}, kernel / library "
                f"{tot['device_ms'] / tot['library_device_ms']:.2f}")
    return rows


def phase_kernels(model, tag):
    return kernel_rows(tag, *record_call_shapes(model, tag))


SUM_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms", "library_device_ms")


def forward_sums(rows, name, batch, tag, dtype="bfloat16"):
    """Sums over the calls of one forward of model `tag` in `dtype` (bf16,
    the edit networks' dtype, unless asked) at one batch size."""
    mine = [r for r in rows if r["kernel"] == name and r["dtype"] == dtype
            and r["shape"][0] == batch and r["model"] == tag]
    return {k: sum(r[k] * r["per_forward"] for r in mine) for k in SUM_KEYS}


# model tag -> (key prefix in the kernels line, batch of the plain keys,
# batch of the keys ending in _b<batch> or None)
SUMMARY = {"P2": ("", 1, 45), "DDPM": ("ddpm_", 1, 45), "SD-UNet": ("sd_unet_", 2, None),
           "SD-decode": ("sd_decode_", 1, None), "SD-encode": ("sd_encode_", 1, None),
           "LCM-UNet": ("lcm_unet_", 1, 3), "IF-I-M": ("if_unet_", 2, None),
           "IF-II-M": ("if_stage2_", 10, None)}


def summarize(rows, name, source, replaces, launches):
    """One kernels-line entry: the sums over the calls of one P2 forward in
    bf16 at batch 1 under the plain keys, at batch 45 under the keys ending
    in _b45; the same sums of one CelebA_HQ_HF forward under keys starting
    with ddpm_, of one SD U-Net forward at batch 2 under sd_unet_, of one
    VAE decode / encode under sd_decode_ / sd_encode_, of one LCM U-Net
    forward at batch 1 (and 3, _b3) under lcm_unet_, of one IF-I-M forward
    at batch 2 under if_unet_ and of one IF-II-M forward at batch 10 under
    if_stage2_. `launches` maps each main path to its count; the entry's
    `launches` is their total."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": sum(launches.values()), "launches_by_path": launches,
             "max_abs_err": max(r["max_abs_err"] for r in rows
                                if r["kernel"] == name and r["dtype"] == "bfloat16")}
    for tag, (prefix, b1, b2) in SUMMARY.items():
        mine = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"
                and r["shape"][0] == b1 and r["model"] == tag]
        if not mine:
            continue
        tot = forward_sums(rows, name, b1, tag)
        by_bytes = sum(r["per_forward"] * r["bound_ms"] for r in mine
                       if r["bound_by"] == "bytes")
        entry.update({f"{prefix}{k}": tot[k] for k in SUM_KEYS})
        entry[f"{prefix}bound_by"] = ("bytes" if by_bytes >= tot["bound_ms"] / 2
                                      else "operations")
        if b2:
            big = forward_sums(rows, name, b2, tag)
            entry.update({f"{prefix}{k}_b{b2}": big[k] for k in SUM_KEYS})
    return entry


def phase_forward_vs_cpu(den, tag):
    """The full-width f32 eps and one J.v of the PMP: the card against the
    CPU, on the card once in full f32 (held to FWD_RTOL) and once with TF32
    convolutions (PyTorch's default; printed)."""
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

    def run(m, dev):
        t0 = time.perf_counter()
        with torch.no_grad():
            eps = m(x.to(dev), t)
        f = pmp_pullback_fn(lambda z, tt: m(z, tt), ab, t)
        jv = torch.func.jvp(f, (x.to(dev),), (v.to(dev),))[1]
        return eps.cpu(), jv.cpu(), time.perf_counter() - t0

    cpu = run(cpu_model, "cpu")
    res = {}
    for allowed in (False, True):
        with tf32_convs(allowed):
            out = run(model, "cuda")
        for i, name in ((0, "eps"), (1, "jv")):
            if not (torch.isfinite(out[i]).all() and out[i].shape == (1, 256, 256, 3)):
                fail(f"full-width {tag} {name} on the card is not finite of shape (1,256,256,3)")
            res[("tf32" if allowed else "f32", name)] = rel_err(out[i], cpu[i])
        if not allowed:
            card_s = out[2]
    log(f"[3 forward] {tag} f32 t={t:.2f}: eps rel err {res[('f32', 'eps')]:.2e} "
        f"(max |eps| {cpu[0].abs().max().item():.3f}), J.v rel err {res[('f32', 'jv')]:.2e} "
        f"(max |Jv| {cpu[1].abs().max().item():.3f}), tol {FWD_RTOL:.0e}; with TF32 "
        f"convolutions (PyTorch's default): eps rel err {res[('tf32', 'eps')]:.2e}, J.v "
        f"rel err {res[('tf32', 'jv')]:.2e}; forward+jvp card {card_s:.2f} s, CPU {cpu[2]:.2f} s")
    for name in ("eps", "jv"):
        if not res[("f32", name)] <= FWD_RTOL:
            fail(f"full-width f32 {tag} {name}: card vs CPU relative error "
                 f"{res[('f32', name)]:.2e} > {FWD_RTOL:.0e}")
    return res


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
    with recording_calls():
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


# (kernel, dtype, call shape, GN eps) of every launch on a main path -> its
# count; main() holds them to the shapes the kernel rows checked
MAIN_PATH_CALLS: dict = {}


def call_key(kernel, dtype, shape, eps=None):
    return (kernel, str(dtype).split(".")[-1], tuple(int(n) for n in shape),
            None if eps is None else f"{eps:.3g}")


class _Recorder:
    """A kernel wrapper that records each call's key first; its `launches`
    is the wrapped function's, which the wrapper increments through its
    module global (this object while recording)."""

    def __init__(self, fn, key):
        self.fn, self.key = fn, key

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))

    def __call__(self, *args, **kwargs):
        k = self.key(*args, **kwargs)
        MAIN_PATH_CALLS[k] = MAIN_PATH_CALLS.get(k, 0) + 1
        return self.fn(*args, **kwargs)


@contextlib.contextmanager
def recording_calls():
    """Records the call shape of each launch into MAIN_PATH_CALLS while on,
    by wrapping the wrappers' module globals, which the autograd functions
    call."""
    from loco_edit_tpu_torch.ops import flash_attention as fa
    from loco_edit_tpu_torch.ops import groupnorm as gn

    gn_fn, fa_fn = gn.group_norm_cuda, fa.flash_attention_cuda
    gn.group_norm_cuda = _Recorder(gn_fn, lambda x, scale, bias, num_groups=32, eps=1e-5:
                                   call_key("groupnorm", x.dtype, x.shape, eps))
    fa.flash_attention_cuda = _Recorder(fa_fn, lambda q, k, v: call_key(
        "flash_attention", q.dtype, (*q.shape[:3], k.shape[2], q.shape[3])))
    try:
        yield
    finally:
        gn.group_norm_cuda, fa.flash_attention_cuda = gn_fn, fa_fn


def check_main_path_calls(rows):
    """Fail unless every call shape a main path gave a kernel was checked
    against the plain version by a kernel row."""
    checked = {call_key(r["kernel"], r["dtype"], r["shape"], r.get("eps")) for r in rows}
    missed = {k: n for k, n in MAIN_PATH_CALLS.items() if k not in checked}
    log(f"[shapes] {len(MAIN_PATH_CALLS)} kernel call shapes on the main paths, "
        f"{sum(MAIN_PATH_CALLS.values())} launches; checked against the plain versions: "
        f"{len(MAIN_PATH_CALLS) - len(missed)}")
    if missed:
        fail(f"main paths launched kernels at shapes no row checked (launches): {missed}")


class ForwardCounter:
    """Counts forward calls of module classes (a global forward pre-hook;
    transforms such as vmap and jvp run a forward once per call), by class
    name; an IF U-Net with the aug-level class embedding (the stage-2
    upscaler) counts as "IFUNet-II"."""

    def __init__(self, *classes):
        self.classes = classes
        self.calls = {c.__name__: 0 for c in classes}

    def _hook(self, mod, args):
        if isinstance(mod, self.classes):
            name = type(mod).__name__
            if getattr(getattr(mod, "cfg", None), "class_embed_timestep", False):
                name += "-II"
            self.calls[name] = self.calls.get(name, 0) + 1

    def __enter__(self):
        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(self._hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def run_main_path(fn, *model_classes):
    """fn() with the kernels' launch counts set to 0 just before and read
    just after, the forwards of each model class counted (by class name),
    the peak device memory and the wall time taken."""
    from loco_edit_tpu_torch.ops.flash_attention import AttentionFn, flash_attention_cuda
    from loco_edit_tpu_torch.ops.groupnorm import GroupNormFn, group_norm_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    copies0 = GroupNormFn.layout_copies, AttentionFn.layout_copies
    with ForwardCounter(*model_classes) as fwd, recording_calls():
        group_norm_cuda.launches = 0
        flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {"groupnorm": group_norm_cuda.launches,
                    "flash_attention": flash_attention_cuda.launches}
    copies = {"groupnorm": GroupNormFn.layout_copies - copies0[0],
              "flash_attention": AttentionFn.layout_copies - copies0[1]}
    log(f"[layout] copies made to hand the kernels their layout: {copies}")
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
    fwd = fwd["DDPMUNet"]
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
    g_fwd = g_fwd["DDPMUNet"]
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


SD_CUTS = "for_steps 20 and inv_steps 20 (not 100); 5 basis sweeps (min_iter = max_iter = 5)"


def load_sd_models(dtype: str):
    """SD 2.1-base U-Net, VAE encoder and decoder with seeded random weights
    on the card, through the CLI's registry (load_sd_bundle)."""
    import argparse

    from loco_edit_tpu_torch.models.t2i_registry import load_sd_bundle

    args = argparse.Namespace(dtype=dtype, checkpoint_path="", vae_path="",
                              text_encoder_path="", device="cuda")
    return load_sd_bundle(args)["models"]


def phase_sd_forward_vs_cpu(models):
    """The full-width f32 U-Net eps (batch 1, a seeded 77 x 1024 context) and
    J.v of decode(PMP(z)) at 512 px: the card against the CPU."""
    from loco_edit_tpu_torch.diffusion import LinspaceDDIM

    cpu = {}
    for name, m in models.items():
        if name == "encoder":
            continue
        with torch.device("cpu"):
            cpu[name] = type(m)(m.cfg)
        cpu[name].load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        cpu[name].requires_grad_(False).eval()
    sched = LinspaceDDIM(noise_schedule="scaled_linear")
    grid = sched.generation_grid(20)
    idx = sched.nearest_step_index(20, 0.7)
    t, ab, sf = float(grid.t[idx]), float(grid.alpha_bar[idx]), 0.18215
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.normal(size=(1, 64, 64, 4)).astype(np.float32))
    ctx = torch.from_numpy((rng.normal(size=(1, 77, 1024)) * 0.2).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 64, 64, 4)).astype(np.float32))
    v = v / v.norm()
    out = {}
    for key, dev, (unet, dec) in (("cuda", "cuda", (models["unet"], models["decoder"])),
                                  ("cuda-tf32", "cuda", (models["unet"], models["decoder"])),
                                  ("cpu", "cpu", (cpu["unet"], cpu["decoder"]))):
        zd, cd = z.to(dev), ctx.to(dev)
        t0 = time.perf_counter()
        with tf32_convs(key == "cuda-tf32"):
            with torch.no_grad():
                eps = unet(zd, t, cd)

            def f(zz):
                e = unet(zz, t, cd)
                return dec((zz - e * np.sqrt(1.0 - ab)) / np.sqrt(ab) / sf)

            image, jv = torch.func.jvp(f, (zd,), (v.to(dev),))
        out[key] = (eps.cpu(), jv.cpu(), time.perf_counter() - t0, image.cpu())
    res = {}
    for i, name, shape in ((0, "eps", (1, 64, 64, 4)), (1, "jv", (1, 512, 512, 3))):
        b = out["cpu"][i]
        for key in ("cuda", "cuda-tf32"):
            a = out[key][i]
            if not (torch.isfinite(a).all() and tuple(a.shape) == shape):
                fail(f"full-width SD {name} on the card is not finite of shape {shape}")
        res[name] = (rel_err(out["cuda"][i], b), b.abs().max().item(),
                     rel_err(out["cuda-tf32"][i], b))
        if not res[name][0] <= FWD_RTOL:
            fail(f"full-width f32 SD {name}: card vs CPU relative error {res[name][0]:.2e} "
                 f"> {FWD_RTOL:.0e}")
    log(f"[3 forward] SD 2.1-base f32 t={t:.2f}: eps rel err {res['eps'][0]:.2e} (max "
        f"|eps| {res['eps'][1]:.3f}), decode(PMP) J.v rel err {res['jv'][0]:.2e} (max "
        f"|Jv| {res['jv'][1]:.3f}), tol {FWD_RTOL:.0e}; with TF32 convolutions "
        f"(PyTorch's default): eps rel err {res['eps'][2]:.2e}, J.v rel err "
        f"{res['jv'][2]:.2e}; forward+jvp card {out['cuda'][2]:.2f} s, CPU "
        f"{out['cpu'][2]:.2f} s")

    # the bf16 networks (the edit's dtype) on the same weights, against the
    # f32 CPU: eps and the decoded image of PMP(z)
    half = {name: bf16_copy(models[name]) for name in ("unet", "decoder")}
    zd, cd = z.cuda(), ctx.cuda()
    with torch.no_grad():
        eps16 = half["unet"](zd, t, cd)
        image16 = half["decoder"]((zd - eps16 * np.sqrt(1.0 - ab)) / np.sqrt(ab) / sf)
    errs = {}
    for name, a, b in (("eps", eps16, out["cpu"][0]), ("decode(PMP)", image16, out["cpu"][3])):
        a = a.float().cpu()
        if not (torch.isfinite(a).all() and a.shape == b.shape):
            fail(f"full-width bf16 SD {name} on the card is not finite of shape {b.shape}")
        errs[name] = (((a - b).norm() / b.norm()).item(),
                      ((a - b).abs().max() / b.abs().max()).item())
    log("[3 forward] SD 2.1-base bf16 on the card vs f32 CPU: " + "; ".join(
        f"{k} rel L2 err {l2:.2e}, rel max err {mx:.2e}" for k, (l2, mx) in errs.items())
        + f"; tol (rel L2) {BF16_FWD_RTOL:.0e}")
    if not all(l2 <= BF16_FWD_RTOL for l2, _ in errs.values()):
        fail(f"full-width bf16 SD: card vs f32 CPU relative L2 error above "
             f"{BF16_FWD_RTOL:.0e}: {errs}")
    del half


def check_t2i_launches(tag, what, launches, fwd, predicted_fwd, per_forward):
    """Launches must be per_forward[name] (GN, attention) per forward of each
    counted model; forwards what the run's steps predict."""
    predicted = {"groupnorm": sum(per_forward[k][0] * fwd.get(k, 0) for k in per_forward),
                 "flash_attention": sum(per_forward[k][1] * fwd.get(k, 0)
                                        for k in per_forward)}
    got_fwd = {k: fwd.get(k, 0) for k in predicted_fwd}
    log(f"[{tag}] {what}: forwards {got_fwd} (predicted {predicted_fwd}); launches "
        f"{launches}, predicted {predicted}")
    if got_fwd != predicted_fwd:
        fail(f"{tag} {what}: forwards {got_fwd} != predicted {predicted_fwd}")
    if launches != predicted:
        fail(f"{tag} {what}: launches {launches} != predicted {predicted}: a path went "
             "around a kernel or launched it more than once per forward")


# GN and attention launches per forward of each counted model
SD_PER_FWD = {"SDUNet": (61, 32), "VAEDecoder": (30, 1), "VAEEncoder": (22, 1)}


def phase_sd_cli(work_dir, image_px=512):
    """The SD edit through the CLI, then the text-supervised direction and an
    inversion from Python on the CLI's pipeline. Returns the launch counts
    of each run. image_px: the VAE's image size (a CPU rehearsal with a
    tiny bundle passes its own)."""
    import functools

    from loco_edit_tpu_torch.cli.main import main as cli_main
    from loco_edit_tpu_torch.models.sd import SDUNet, VAEDecoder, VAEEncoder
    from loco_edit_tpu_torch.pipelines import sd as sd_pipeline

    root = os.path.join(work_dir, "sd")
    mask_dir = os.path.join(root, "Stable_Diffusion-Random-", "results", "mask")
    os.makedirs(mask_dir)
    px = image_px
    masks = np.zeros((1, px, px, 3), bool)
    masks[:, px // 4:3 * px // 4, 5 * px // 16:11 * px // 16] = True
    np.savez(os.path.join(mask_dir, "mask.npz"), masks=masks)
    for_prompt, edit_prompt = "a photo of a cat", "a photo of a cat wearing sunglasses"
    argv = ["--model_name", "stabilityai/stable-diffusion-2-1-base", "--dtype", "bf16",
            "--device", "cuda", "--dataset_name", "Random", "--for_prompt", for_prompt,
            "--edit_prompt", edit_prompt, "--guidance_scale", "7.5",
            "--for_steps", "20", "--inv_steps", "20", "--edit_t", "0.7",
            "--performance_boosting_t", "0", "--use_x_space_guidance", "true",
            "--h_t", "0.7", "--x_space_guidance_num_step", "8", "--vis_num", "4",
            "--pca_rank", "5", "--pca_rank_null", "5", "--null_space_projection", "true",
            "--use_mask", "true", "--run_edit_null_space_projection_zt", "true",
            "--seed", "1", "--result_folder", root]
    log(f"[8 sd] python -m loco_edit_tpu_torch.cli.main {' '.join(argv)}; cuts: {SD_CUTS}")
    pipes = []
    run_zt = sd_pipeline.SDEditPipeline.run_edit_null_space_projection_zt

    def capture(self, *a, **k):
        pipes.append(self)
        return run_zt(self, *a, **k)

    config = sd_pipeline.SDEditConfig
    sd_pipeline.SDEditPipeline.run_edit_null_space_projection_zt = capture
    sd_pipeline.SDEditConfig = functools.partial(config, min_iter=5, max_iter=5)
    try:
        res, launches, fwd, total_s, peak = run_main_path(
            lambda: cli_main(argv), SDUNet, VAEDecoder, VAEEncoder)
    finally:
        sd_pipeline.SDEditPipeline.run_edit_null_space_projection_zt = run_zt
        sd_pipeline.SDEditConfig = config
    pipe = pipes[0]
    out = res["edit"]
    n_frames = 5 * 9
    chunks = -(-n_frames // pipe.cfg.memory_bound)
    steps_left = len(pipe.gen_grid) - pipe.edit_t_idx
    vT = out["vT"]
    norms = np.linalg.norm(vT, axis=1)
    lat = (1,) + tuple(pipe.latent_shape)
    files = sorted(os.listdir(out["out_dir"])) + sorted(
        os.listdir(os.path.join(out["out_dir"], "basis")))
    checks = {
        "config": (pipe.cfg.min_iter, pipe.cfg.max_iter, pipe.cfg.memory_bound) == (5, 5, 5),
        "zt": out["zt"].shape == lat and bool(np.isfinite(out["zt"]).all()),
        "vT_shape": list(vT.shape) == [5, int(np.prod(lat))],
        "vT_finite": bool(np.isfinite(vT).all()),
        "vT_unit_norm": bool(np.abs(norms - 1).max() < 1e-4),
        "strips": sorted(out["strips"]) == list(range(5)) and all(
            s.shape == (9, px, px, 3) and np.isfinite(s).all()
            for s in out["strips"].values()),
        "pngs": sum(f.startswith("edit-zt-0.7T-pc") and f.endswith(".png")
                    for f in files) == 5,
        "npz": "vT.npz" in files and sum(f.startswith(("vT-modify-", "vT-null-"))
                                         for f in files) == 2,
    }
    phases = {k: round(v, 3) for k, v in res["timings"]["edit"].items()}
    log(f"[8 sd] edit: {total_s:.2f} s total (model build included); phases (s) "
        f"{phases}; peak device memory {peak:.2f} GiB; {chunks} strip chunks of "
        f"{pipe.cfg.memory_bound} frames; checks {checks}; |vT| rows "
        f"{norms.round(6).tolist()}")
    if not all(checks.values()):
        fail(f"SD CLI edit checks failed: {checks}")
    check_t2i_launches("8 sd", "edit", launches, fwd, {
        "SDUNet": pipe.edit_t_idx + 1 + 5 + chunks * steps_left,
        "VAEDecoder": 1 + 5 + chunks, "VAEEncoder": 0}, SD_PER_FWD)

    prompts = pipe.prompt_set(for_prompt, edit_prompt)
    mode = pipe.cfg.tilda_v_score_type
    d_vT, d_launches, d_fwd, d_s, d_peak = run_main_path(
        lambda: pipe.delta_zt_via_grad(out["zt"], prompts, masks, mode),
        SDUNet, VAEDecoder, VAEEncoder)
    d_vT = d_vT.cpu().numpy()
    d_checks = {"shape": d_vT.shape == (1, int(np.prod(lat))),
                "finite": bool(np.isfinite(d_vT).all()),
                "unit_norm": abs(float(np.linalg.norm(d_vT)) - 1) < 1e-4}
    log(f"[8 sd] delta_zt_via_grad ({mode}): {d_s:.2f} s; peak device memory "
        f"{d_peak:.2f} GiB; checks {d_checks}")
    if not all(d_checks.values()):
        fail(f"SD text-supervised direction checks failed: {d_checks}")
    check_t2i_launches("8 sd", "delta_zt_via_grad", d_launches, d_fwd,
                       {"SDUNet": 3, "VAEDecoder": 3, "VAEEncoder": 0}, SD_PER_FWD)

    yy, xx = np.mgrid[:px, :px] / px
    img = np.random.default_rng(4).uniform(-0.2, 0.2, (px, px, 3))
    x0 = np.clip(np.stack([yy, xx, 1 - yy], -1) * 1.6 - 0.8 + img, -1, 1)
    zT, i_launches, i_fwd, i_s, i_peak = run_main_path(
        lambda: pipe.invert(x0[None].astype(np.float32)), SDUNet, VAEDecoder, VAEEncoder)
    i_checks = {"shape": tuple(zT.shape) == lat,
                "finite": bool(torch.isfinite(zT).all())}
    log(f"[8 sd] invert ({px} px image, {len(pipe.inv_grid)} steps): {i_s:.2f} s; peak "
        f"device memory {i_peak:.2f} GiB; |zT| std {zT.float().std().item():.3f}; "
        f"checks {i_checks}")
    if not all(i_checks.values()):
        fail(f"SD inversion checks failed: {i_checks}")
    check_t2i_launches("8 sd", "invert", i_launches, i_fwd, {
        "SDUNet": len(pipe.inv_grid), "VAEDecoder": 0, "VAEEncoder": 1}, SD_PER_FWD)
    return launches, d_launches, i_launches


def sam_sampling_run(tag, cli_main, argv, px):
    """The first phase of the SAM protocol: argv + --sampling_mode true must
    make the image, cache its SAM masks ((n, px, px, 3) bool) with an
    overlay each and exit 0 (the only SystemExit taken). Returns the masks."""
    import glob

    log(f"[{tag}] sampling run: python -m loco_edit_tpu_torch.cli.main {' '.join(argv)} "
        "--sampling_mode true")
    t0 = time.perf_counter()
    try:
        cli_main(argv + ["--sampling_mode", "true"])
    except SystemExit as e:
        if e.code != 0:
            raise
    else:
        fail(f"{tag}: the --sampling_mode run did not exit")
    total_s = time.perf_counter() - t0
    root = argv[argv.index("--result_folder") + 1]
    found = glob.glob(os.path.join(root, "**", "mask", "mask.npz"), recursive=True)
    if len(found) != 1:
        fail(f"{tag}: the --sampling_mode run cached {found}")
    with np.load(found[0]) as z:
        masks = z["masks"]
    overlays = sorted(f for f in os.listdir(os.path.dirname(found[0])) if f.endswith(".png"))
    checks = {"masks": masks.ndim == 4 and masks.shape[1:] == (px, px, 3)
              and masks.dtype == bool and len(masks) >= 1,
              "overlays": overlays == [f"mask_{i:03d}.png" for i in range(len(masks))]}
    log(f"[{tag}] sampling run: {total_s:.2f} s (model and SAM build included); "
        f"{len(masks)} masks {tuple(masks.shape)}, areas "
        f"{[round(float(m[..., 0].mean()), 3) for m in masks]}; checks {checks}")
    if not all(checks.values()):
        fail(f"{tag}: --sampling_mode checks failed: {checks}")
    return masks


LCM_CUTS = "5 basis sweeps (min_iter = max_iter = 5; the reference: 10-50 until 1e-3)"
LCM_W = 6.5     # the guidance embedding's w = guidance_scale - 1 at guidance 7.5


def load_lcm_models(dtype: str):
    """LCM Dreamshaper v7 (the SD 1.5 U-Net with cond_proj) and its 512 px
    VAE with seeded random weights on the card, through the CLI's registry
    (load_sd_bundle with lcm=True)."""
    import argparse

    from loco_edit_tpu_torch.models.t2i_registry import load_sd_bundle

    args = argparse.Namespace(dtype=dtype, checkpoint_path="", vae_path="",
                              text_encoder_path="", device="cuda")
    return load_sd_bundle(args, lcm=True)["models"]


def unet_vs_cpu(tag, unet, args, bf16_unet, stages=()):
    """A full-width f32 U-Net's eps on the card against the same weights on
    the CPU (FWD_RTOL of the largest |eps|), then the bf16 U-Net on the same
    weights against the f32 CPU (relative L2 within BF16_FWD_RTOL). With
    `stages` (submodule names), the output of each in the same f32 forward
    is compared too (forward hooks); returns their relative errors."""
    with torch.device("cpu"):
        cpu = type(unet)(unet.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in unet.state_dict().items()})
    cpu.requires_grad_(False).eval()
    out, seen, hooks = {}, {"cuda": {}, "cpu": {}}, []
    for dev, m in (("cuda", unet), ("cpu", cpu)):
        mods = dict(m.named_modules())
        for name in stages:
            hooks.append(mods[name].register_forward_hook(
                lambda mod, a, o, name=name, dev=dev: seen[dev].__setitem__(
                    name, o.detach().float().cpu())))
        t0 = time.perf_counter()
        with torch.no_grad():
            out[dev] = (m(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                            for a in args)).cpu(), time.perf_counter() - t0)
    for h in hooks:
        h.remove()
    a, b = out["cuda"][0], out["cpu"][0]
    if not (torch.isfinite(a).all() and a.shape == b.shape):
        fail(f"full-width f32 {tag} eps on the card is not finite of shape {tuple(b.shape)}")
    rel = ((a - b).abs().max() / b.abs().max()).item()
    with torch.no_grad():
        e16 = bf16_unet(*(a.cuda() if isinstance(a, torch.Tensor) else a
                          for a in args)).float().cpu()
    if not (torch.isfinite(e16).all() and e16.shape == b.shape):
        fail(f"full-width bf16 {tag} eps on the card is not finite of shape {tuple(b.shape)}")
    l2 = ((e16 - b).norm() / b.norm()).item()
    mx = ((e16 - b).abs().max() / b.abs().max()).item()
    log(f"[3 forward] {tag} f32 eps card vs CPU rel err {rel:.2e} (max |eps| "
        f"{b.abs().max().item():.3f}), tol {FWD_RTOL:.0e}; forward card {out['cuda'][1]:.2f} s, "
        f"CPU {out['cpu'][1]:.2f} s; bf16 on the card vs f32 CPU: rel L2 err {l2:.2e}, "
        f"rel max err {mx:.2e}, tol (rel L2) {BF16_FWD_RTOL:.0e}")
    if not rel <= FWD_RTOL:
        fail(f"full-width f32 {tag} eps: card vs CPU relative error {rel:.2e} > {FWD_RTOL:.0e}")
    if not l2 <= BF16_FWD_RTOL:
        fail(f"full-width bf16 {tag} eps: relative L2 error {l2:.2e} > {BF16_FWD_RTOL:.0e}")
    return {name: rel_err(seen["cuda"][name], seen["cpu"][name]) for name in stages}


def bf16_copy(model):
    """The same network in bf16 on the card, loaded from model's weights."""
    with torch.device("cuda"):
        half = type(model)(dataclasses.replace(model.cfg, dtype=torch.bfloat16))
    half.load_state_dict(model.state_dict())
    return half.requires_grad_(False).eval()


def phase_lcm_kernels_and_forward(models):
    """Phase 9's kernel rows at every LCM U-Net call shape (batch 1 and the
    strip's 3), and the full-width eps checks."""
    unet = models["unet"]
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.normal(size=(1, 64, 64, 4)).astype(np.float32))
    ctx = torch.from_numpy((rng.normal(size=(1, 77, 768)) * 0.2).astype(np.float32))
    w = torch.full((1,), LCM_W)
    rows = kernel_rows("LCM-UNet", *record_t2i_call_shapes(
        unet, z.cuda(), 759.0, ctx.cuda(), w.cuda()))
    half = bf16_copy(unet)
    # the f32 gap by stage: every top-level block in forward order, and the
    # submodules of the first D = 40 transformer (the 1x1-conv projections)
    stages = [n for n, _ in unet.named_children()] + [
        n for n, _ in unet.named_modules() if n.startswith("down_0_attn_0.")]
    errs = unet_vs_cpu("LCM Dreamshaper v7 (t=759, w=6.5)", unet, (z, 759.0, ctx, w), half,
                       stages)
    del half
    worst = max(errs, key=errs.get)
    log("[9 lcm] f32 card vs CPU by stage (max |card - CPU| / max |CPU| of each output): "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f"; largest {worst} {errs[worst]:.2e}")
    return rows


LCM_PROMPTS = ("A photo of a man", "A photo of a man having curly hair")


def lcm_argv(root, dtype):
    """The command of scripts/main_T2I_LCM_null_space_projection_nonsemantic.sh
    through the port's CLI at `dtype`, with --device cuda, --mask_backend
    flax and --result_folder root."""
    for_prompt, edit_prompt = LCM_PROMPTS
    return ["--model_name", "LCM_Dreamshaper_v7", "--dataset_name", "Random",
            "--dtype", dtype, "--device", "cuda", "--for_prompt", for_prompt,
            "--edit_prompt", edit_prompt, "--guidance_scale", "7.5",
            "--guidance_scale_edit", "7.5", "--num_inference_steps", "4",
            "--edit_t_idx", "2", "--x_space_guidance_scale", "0.4",
            "--x_space_guidance_num_step", "24", "--run_edit_null_space_projection_zt",
            "true", "--null_space_projection", "true", "--pca_rank", "5",
            "--pca_rank_null", "5", "--tilda_v_score_type", "null+(for-null)+(edit-null)",
            "--non_semantic", "true", "--use_yh_custom_scheduler", "false",
            "--use_mask", "true", "--mask_index", "0", "--note", "nonsemantic",
            "--seed", "0", "--vis_num", "1", "--mask_backend", "flax",
            "--result_folder", root]


def lcm_cli_edit(tag, argv, px, sweeps):
    """One LCM edit through the CLI (its mask read from the cache) with
    `sweeps` fixed basis sweeps, on the main path: the result checked, its
    phases, peak memory and launches printed, the launches held to its
    forwards. Returns (launches, the CLI's pipeline, the edit's result)."""
    import functools

    from loco_edit_tpu_torch.cli.main import main as cli_main
    from loco_edit_tpu_torch.models.sd import SDUNet, VAEDecoder, VAEEncoder
    from loco_edit_tpu_torch.pipelines import lcm as lcm_pipeline

    pipes = []
    run_zt = lcm_pipeline.LCMEditPipeline.run_edit_null_space_projection_zt

    def capture(self, *a, **k):
        pipes.append(self)
        return run_zt(self, *a, **k)

    config = lcm_pipeline.LCMEditConfig
    lcm_pipeline.LCMEditPipeline.run_edit_null_space_projection_zt = capture
    lcm_pipeline.LCMEditConfig = functools.partial(config, min_iter=sweeps, max_iter=sweeps)
    try:
        res, launches, fwd, total_s, peak = run_main_path(
            lambda: cli_main(argv), SDUNet, VAEDecoder, VAEEncoder)
    finally:
        lcm_pipeline.LCMEditPipeline.run_edit_null_space_projection_zt = run_zt
        lcm_pipeline.LCMEditConfig = config
    pipe = pipes[0]
    out = res["edit"]
    n_frames = out["image"].shape[0]
    chunks = -(-n_frames // pipe.cfg.memory_bound)
    steps_left = len(pipe.grid) - pipe.cfg.edit_t_idx
    vT = out["vT"]
    norms = np.linalg.norm(vT, axis=1)
    lat = (1,) + tuple(pipe.latent_shape)
    files = sorted(os.listdir(out["out_dir"])) + sorted(
        os.listdir(os.path.join(out["out_dir"], "basis")))
    checks = {
        "config": (pipe.cfg.min_iter, pipe.cfg.max_iter, pipe.w) == (sweeps, sweeps, LCM_W),
        "grid": pipe.grid.t.tolist() == [999, 759, 519, 279],
        "zt": out["zt"].shape == lat and bool(np.isfinite(out["zt"]).all()),
        "vT_shape": list(vT.shape) == [5, int(np.prod(lat))],
        "vT_finite": bool(np.isfinite(vT).all()),
        "vT_unit_norm": bool(np.abs(norms - 1).max() < 1e-4),
        "strip": out["image"].shape == (3, px, px, 3) and bool(np.isfinite(out["image"]).all()),
        "png": "edit-lcm-idx2.png" in files, "npz": "vT.npz" in files,
    }
    phases = {k: round(v, 3) for k, v in res["timings"]["edit"].items()}
    log(f"[{tag}] edit: {total_s:.2f} s total (model build included); phases (s) "
        f"{phases}; peak device memory {peak:.2f} GiB; {n_frames} strip frames in "
        f"{chunks} chunk(s); checks {checks}; |vT| rows {norms.round(6).tolist()}")
    if not all(checks.values()):
        fail(f"{tag}: LCM CLI edit checks failed: {checks}")
    # U-Net: generate (edit_t_idx steps) + basis (1 vjp primal + 1 jvp primal
    # per sweep) + strip (chunks x the remaining steps); decodes: basis + strip
    check_t2i_launches(tag, "edit", launches, fwd, {
        "SDUNet": pipe.cfg.edit_t_idx + 1 + sweeps + chunks * steps_left,
        "VAEDecoder": 1 + sweeps + chunks, "VAEEncoder": 0}, SD_PER_FWD)
    return launches, pipe, out


def phase_lcm_cli(work_dir, image_px=512):
    """The LCM edit through the CLI at the reference script's settings
    (scripts/main_T2I_LCM_null_space_projection_nonsemantic.sh), bf16, its
    mask from a --sampling_mode run, then delta_zt_via_grad from Python on
    the CLI's pipeline. Returns the launch counts of each run. image_px: the
    VAE's image size (a CPU rehearsal with a tiny bundle passes its own)."""
    from loco_edit_tpu_torch.cli.main import main as cli_main
    from loco_edit_tpu_torch.models.sd import SDUNet, VAEDecoder, VAEEncoder

    argv = lcm_argv(os.path.join(work_dir, "lcm"), "bf16")
    px = image_px
    masks = sam_sampling_run("9 lcm", cli_main, argv, px)
    log(f"[9 lcm] python -m loco_edit_tpu_torch.cli.main {' '.join(argv)}; cuts: {LCM_CUTS}")
    launches, pipe, out = lcm_cli_edit("9 lcm", argv, px, 5)
    lat = (1,) + tuple(pipe.latent_shape)

    d_vT, d_launches, d_fwd, d_s, d_peak = run_main_path(
        lambda: pipe.delta_zt_via_grad(out["zt"], *LCM_PROMPTS, masks[:1]),
        SDUNet, VAEDecoder, VAEEncoder)
    d_vT = d_vT.cpu().numpy()
    d_checks = {"shape": d_vT.shape == (1, int(np.prod(lat))),
                "finite": bool(np.isfinite(d_vT).all()),
                "unit_norm": abs(float(np.linalg.norm(d_vT)) - 1) < 1e-4}
    log(f"[9 lcm] delta_zt_via_grad: {d_s:.2f} s; peak device memory {d_peak:.2f} GiB; "
        f"checks {d_checks}")
    if not all(d_checks.values()):
        fail(f"LCM text-supervised direction checks failed: {d_checks}")
    check_t2i_launches("9 lcm", "delta_zt_via_grad", d_launches, d_fwd,
                       {"SDUNet": 3, "VAEDecoder": 3, "VAEEncoder": 0}, SD_PER_FWD)
    return launches, d_launches


# basis sweeps of the f32 LCM edit (fixed, as in the bf16 run)
LCM_F32_SWEEPS = 5


def phase_lcm_f32_cli(work_dir, image_px=512):
    """The same LCM command at the script's own dtype, --dtype fp32 (the
    3xTF32 attention route and full-f32 convolutions), reading the mask the
    bf16 run's --sampling_mode pass cached (copied into its own result
    folder), with LCM_F32_SWEEPS fixed sweeps. Returns its launch counts."""
    import glob
    import shutil

    from loco_edit_tpu_torch.ops.flash_attention import route

    src = os.path.join(work_dir, "lcm")
    root = os.path.join(work_dir, "lcm_f32")
    found = glob.glob(os.path.join(src, "**", "mask", "mask.npz"), recursive=True)
    if len(found) != 1:
        fail(f"9 lcm f32: expected the bf16 run's cached mask, found {found}")
    mask_dir = os.path.dirname(found[0])
    shutil.copytree(mask_dir, os.path.join(root, os.path.relpath(mask_dir, src)))
    argv = lcm_argv(root, "fp32")
    cuts = (f"{LCM_F32_SWEEPS} basis sweeps (min_iter = max_iter = {LCM_F32_SWEEPS}; "
            "the reference: 10-50 until 1e-3)")
    log(f"[9 lcm f32] python -m loco_edit_tpu_torch.cli.main {' '.join(argv)}; mask: the "
        f"bf16 run's {os.path.relpath(found[0], work_dir)}; cuts: {cuts}; attention routes "
        + ", ".join(route(torch.float32, d) for d in (40, 80, 160)))
    launches, _, _ = lcm_cli_edit("9 lcm f32", argv, image_px, LCM_F32_SWEEPS)
    log(f"[9 lcm f32] launches on the f32 routes: attention {launches['flash_attention']}, "
        f"GroupNorm {launches['groupnorm']}")
    return launches


IF_PER_FWD = {"IFUNet": (117, 22), "IFUNet-II": (89, 8)}


def write_if_checkpoint(preset: str, path: str, seed: int) -> int:
    """A seeded diffusers-named state_dict of an IF preset at full width
    (the port's weights under the converter's diffusers names), written to
    path; returns its parameter count."""
    from loco_edit_tpu_torch.models.ifm import IFUNet, if_preset
    from loco_edit_tpu_torch.models.ifm.convert import _if_rules
    from loco_edit_tpu_torch.models.sd.convert import _rename

    with torch.device("cuda"):
        m = IFUNet(if_preset(preset))
    m.init_random_(torch.Generator("cuda").manual_seed(seed))
    rules = _if_rules(m.cfg)
    torch.save({_rename(k, rules): v.detach().cpu() for k, v in m.state_dict().items()},
               path)
    n = sum(p.numel() for p in m.parameters())
    del m
    return n


def phase_if_kernels_and_forward(ckpt1, ckpt2):
    """Phase 10's kernel rows at every IF-I-M call shape (the CFG batch 2)
    and every IF-II-M one (5 frames x CFG 2), and the IF-I-M eps checks; the
    models loaded from the written checkpoints through the CLI's registry
    (infer_if_config and the converter at full width)."""
    from loco_edit_tpu_torch.models.t2i_registry import _load_if_model

    dev = torch.device("cuda")
    unet = _load_if_model(ckpt1, torch.float32, dev)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
    ctx = torch.from_numpy((rng.normal(size=(1, 77, 4096)) * 0.2).astype(np.float32))
    rows = kernel_rows("IF-I-M", *record_t2i_call_shapes(
        unet, torch.cat([x, x]).cuda(), 742.5, torch.cat([ctx, ctx]).cuda()))
    half = bf16_copy(unet)
    unet_vs_cpu("IF-I-M (t=742.5)", unet, (x, 742.5, ctx), half)
    log(f"[10 if] IF-I-M from {os.path.basename(ckpt1)}: inferred {unet.cfg.block_out_channels} "
        f"x {unet.cfg.layers_per_block}, {sum(p.numel() for p in unet.parameters()):,} "
        "parameters")
    del unet, half
    stage2 = _load_if_model(ckpt2, torch.float32, dev, stage2=True)
    y = torch.zeros(10, 256, 256, 6, device="cuda")
    rows += kernel_rows("IF-II-M", *record_t2i_call_shapes(
        stage2, y, 500.0, torch.zeros(10, 77, 4096, device="cuda"), 250.0))
    log(f"[10 if] IF-II-M from {os.path.basename(ckpt2)}: "
        f"{sum(p.numel() for p in stage2.parameters()):,} parameters")
    del stage2
    return rows


def phase_if_cli(work_dir, ckpt1, ckpt2):
    """The semantic IF edit through the CLI at the reference script's
    settings (scripts/main_T2I_DeepFloydIF_null_space_projection.sh) with the
    DiffEdit mask, bf16, from the written IF-I-M checkpoint, then the
    IF-II-M upscale of the strip. Returns the launch counts."""
    from loco_edit_tpu_torch.cli.main import main as cli_main
    from loco_edit_tpu_torch.models.ifm import IFUNet
    from loco_edit_tpu_torch.pipelines import deepfloyd

    root = os.path.join(work_dir, "if")
    argv = ["--model_name", "DeepFloyd-IF-I-M", "--dataset_name", "Random",
            "--dtype", "bf16", "--device", "cuda", "--checkpoint_path", ckpt1,
            "--stage2_checkpoint_path", ckpt2, "--for_prompt", "A photo of a man",
            "--edit_prompt", "A photo of a man wearing glasses", "--guidance_scale", "7.0",
            "--guidance_scale_edit", "4.0", "--for_steps", "100", "--edit_t", "0.75",
            "--performance_boosting_t", "0", "--x_space_guidance_scale", "1.0",
            "--x_space_guidance_num_step", "4",
            "--run_edit_null_space_projection_xt_semantic", "true",
            "--null_space_projection", "true", "--pca_rank", "1", "--pca_rank_null", "5",
            "--tilda_v_score_type", "(for-edit)-direct", "--jacobian", "false",
            "--use_mask", "true", "--mask_type", "diffedit", "--seed", "1",
            "--vis_num", "2", "--result_folder", root]
    log(f"[10 if] python -m loco_edit_tpu_torch.cli.main {' '.join(argv)}")
    pipes = []
    run_xt = deepfloyd.IFEditPipeline.run_edit_null_space_projection_xt

    def capture(self, *a, **k):
        pipes.append(self)
        return run_xt(self, *a, **k)

    deepfloyd.IFEditPipeline.run_edit_null_space_projection_xt = capture
    try:
        res, launches, fwd, total_s, peak = run_main_path(lambda: cli_main(argv), IFUNet)
    finally:
        deepfloyd.IFEditPipeline.run_edit_null_space_projection_xt = run_xt
    pipe = pipes[0]
    out, mask = res["edit"], res["mask"]
    n_frames = out["stage1"].shape[0]
    chunks = -(-n_frames // pipe.cfg.memory_bound)
    steps = len(pipe.gen_grid)
    vT = out["vT"]
    files = sorted(os.listdir(out["out_dir"])) + sorted(
        os.listdir(os.path.join(out["out_dir"], "basis")))
    shape, hi = pipe.sample_shape, pipe.superres.out_size
    log(f"[10 if] stage 1 at {shape}, stage 2 at {hi} px (inferred from the checkpoints)")
    checks = {
        "mask": mask.shape == (1, *shape) and 0 < mask.mean() < 1,
        "xt": out["xt"].shape == (1, *shape) and bool(np.isfinite(out["xt"]).all()),
        "vT_shape": list(vT.shape) == [1, int(np.prod(shape))],
        "vT_finite": bool(np.isfinite(vT).all()),
        "vT_unit_norm": abs(float(np.linalg.norm(vT)) - 1) < 1e-4,
        "stage1": out["stage1"].shape == (5, *shape)
        and bool(np.isfinite(out["stage1"]).all()),
        "stage2": out["image"].shape == (5, hi, hi, 3)
        and bool(np.isfinite(out["image"]).all()) and float(np.abs(out["image"]).max()) <= 1,
        "pngs": {"edit-if-stage1.png", "edit-if-stage2.png"} <= set(files),
        "npz": "vT.npz" in files,
    }
    phases = {k: round(v, 3) for k, v in res["timings"]["edit"].items()}
    n1 = fwd.get("IFUNet", 0)
    # stage 1: the DiffEdit sample (all steps) + the mask's two eps calls +
    # generate to edit_t + the direct direction + the null basis (1 + one per
    # sweep) + the strip; stage 2: the 50-step upscale grid
    fixed = steps + 2 + pipe.edit_t_idx + 1 + 1 + chunks * (steps - pipe.edit_t_idx)
    sweeps = n1 - fixed
    checks["sweeps_in_range"] = 10 <= sweeps <= 50   # IFEditConfig min/max_iter
    log(f"[10 if] edit: {total_s:.2f} s total (checkpoint loads included); phases (s) "
        f"{phases}; peak device memory {peak:.2f} GiB; DiffEdit mask {mask.mean():.3f} of "
        f"pixels; {sweeps} null-basis sweeps; {n_frames} strip frames; checks {checks}")
    if not all(checks.values()):
        fail(f"IF CLI edit checks failed: {checks}")
    sr_steps = len(pipe.superres.grid)
    check_t2i_launches("10 if", "edit", launches, fwd,
                       {"IFUNet": fixed + sweeps, "IFUNet-II": sr_steps}, IF_PER_FWD)
    return launches


def phase_sam():
    """Phase 11: SAM at facebook/sam-vit-large's geometry with seeded random
    weights (prepare_sam's hub-name branch): the parameter count; the f32
    encoder embedding and one 64-point decode batch (logits, IoU) on the
    card against the same model on the CPU, in full f32 (held to FWD_RTOL)
    and with TF32 convolutions (printed); then automatic mask generation on a
    seeded 512 px image, timed (the second of two runs)."""
    from loco_edit_tpu_torch.masks.sam import prepare_sam, segment_image_on_device

    t0 = time.perf_counter()
    bundle = prepare_sam("facebook/sam-vit-large", device="cuda", seed=0)
    build_s = time.perf_counter() - t0
    counts = [sum(p.numel() for p in m.parameters()) for m in (bundle.encoder, bundle.decoder)]
    log(f"[11 sam] ViT-L encoder {counts[0]:,} and decoder {counts[1]:,} parameters (the JAX "
        f"build's {SAM_ENCODER_PARAMS:,} and {SAM_DECODER_PARAMS:,}); seeded in {build_s:.1f} s")
    if counts != [SAM_ENCODER_PARAMS, SAM_DECODER_PARAMS]:
        fail(f"SAM parameter counts {counts} != {[SAM_ENCODER_PARAMS, SAM_DECODER_PARAMS]}")

    cpu = {}
    for name in ("encoder", "decoder"):
        m = getattr(bundle, name)
        with torch.device("cpu"):
            cpu[name] = type(m)(m.cfg)
        cpu[name].load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        cpu[name].requires_grad_(False).eval()
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(1, 1024, 1024, 3)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(0, 1024, (1, 64, 1, 2)).astype(np.float32))
    lbl = torch.ones(1, 64, 1, dtype=torch.int32)

    def run(enc, dec, dev):
        t0 = time.perf_counter()
        with torch.no_grad():
            emb = enc(x.to(dev))
            m, iou = dec(emb, points=pts.to(dev), labels=lbl.to(dev))
        return emb.cpu(), m.cpu(), iou.cpu(), time.perf_counter() - t0

    ref = run(cpu["encoder"], cpu["decoder"], "cpu")
    res = {}
    for allowed in (False, True):
        with tf32_convs(allowed):
            out = run(bundle.encoder, bundle.decoder, "cuda")
        for i, name, shape in ((0, "embedding", (1, 64, 64, 256)),
                               (1, "logits", (1, 64, 3, 256, 256)), (2, "iou", (1, 64, 3))):
            if not (torch.isfinite(out[i]).all() and tuple(out[i].shape) == shape):
                fail(f"SAM {name} on the card is not finite of shape {shape}")
            res[("tf32" if allowed else "f32", name)] = rel_err(out[i], ref[i])
    log("[11 sam] f32 card vs CPU (max |card - CPU| / max |CPU|): " + ", ".join(
        f"{n} {res[('f32', n)]:.2e}" for n in ("embedding", "logits", "iou"))
        + f", tol {FWD_RTOL:.0e}; with TF32 convolutions (PyTorch's default): "
        + ", ".join(f"{n} {res[('tf32', n)]:.2e}" for n in ("embedding", "logits", "iou"))
        + f"; encode + one decode batch: card {out[3]:.2f} s, CPU {ref[3]:.2f} s")
    bad = {n: e for (k, n), e in res.items() if k == "f32" and not e <= FWD_RTOL}
    if bad:
        fail(f"SAM f32 card vs CPU relative errors above {FWD_RTOL:.0e}: {bad}")
    del cpu

    yy, xx = np.mgrid[:512, :512] / 512
    img = np.random.default_rng(12).uniform(0, 40, (512, 512, 3)) + 200 * np.stack(
        [yy, xx, 1 - yy], -1)
    img[((yy - 0.5) / 0.3) ** 2 + ((xx - 0.45) / 0.2) ** 2 < 1] = (200, 150, 120)
    img = img.astype(np.uint8)
    for _ in range(2):
        masks = segment_image_on_device(img, prepared=bundle, resolution=512)
    t = bundle.timings
    checks = {"masks": masks.ndim == 3 and masks.shape[1:] == (512, 512)
              and masks.dtype == bool and len(masks) >= 1}
    log(f"[11 sam] automatic masks of a 512 px image, 32 x 32 points: encode "
        f"{t['encode'] * 1e3:.1f} ms, decode {t['decode'] * 1e3 / t['decode_batches']:.1f} ms "
        f"a batch of 64 points ({t['decode_batches']} batches), host filters and NMS "
        f"{t['filter'] * 1e3:.1f} ms; {t['candidates']} candidates, {t['kept']} masks kept, "
        f"areas {[round(float(m.mean()), 3) for m in masks]}; checks {checks}")
    if not all(checks.values()):
        fail(f"SAM mask checks failed: {checks}")
    del bundle
    return res


P2_SCRIPT = "scripts/main_hf_null_space_projection_FFHQ_P2.sh"


def write_ffhq_folder(root, size=256, seed=13):
    """A seeded one-image FFHQ-style folder: a face-like picture (skin and
    hair ellipses, eyes, mouth over a gradient) as 00000.png."""
    from PIL import Image

    os.makedirs(root)
    yy, xx = np.mgrid[:size, :size] / size
    img = (np.random.default_rng(seed).uniform(0, 30, (size, size, 3))
           + 150 * np.stack([1 - yy, 0.6 + 0 * xx, yy], -1))
    for (cy, cx, ry, rx), rgb in (((0.3, 0.5, 0.25, 0.33), (60, 40, 30)),
                                  ((0.55, 0.5, 0.33, 0.26), (220, 170, 140)),
                                  ((0.48, 0.4, 0.03, 0.05), (40, 40, 60)),
                                  ((0.48, 0.6, 0.03, 0.05), (40, 40, 60)),
                                  ((0.72, 0.5, 0.04, 0.1), (170, 60, 60))):
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = rgb
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        os.path.join(root, "00000.png"))
    return root


# phase 12's cut: each of its two bases runs this many sweeps (the CLI's
# UncondEditConfig takes 10-50 until 1e-3), as phases 8 and 9 fix theirs
P2_SAM_SWEEPS = 5
P2_SAM_CUTS = (f"{P2_SAM_SWEEPS} basis sweeps a basis (min_iter = max_iter = "
               f"{P2_SAM_SWEEPS}; the script's CLI: 10-50 until 1e-3)")


def phase_p2_sam_cli(work_dir, model_name="FFHQ_P2", image_px=256):
    """Phase 12: scripts/main_hf_null_space_projection_FFHQ_P2.sh through
    cli.main.main with every flag it passes, plus --device cuda, the
    synthetic folder as --dataset_root, --result_folder and --mask_backend
    flax: f32, seeded random P2 and SAM ViT-L weights, the port's own
    backend flags. The --sampling_mode true run caches the SAM masks and
    exits 0; the rerun (--sampling_mode false, as the script passes it)
    edits with --mask_index 0. Cut: P2_SAM_SWEEPS fixed sweeps a basis.
    Returns the edit's launch counts. model_name and image_px: a CPU
    rehearsal passes a tiny model's."""
    import functools

    from loco_edit_tpu_torch import pipelines
    from loco_edit_tpu_torch.cli.main import main as cli_main
    from loco_edit_tpu_torch.models.adm import ADMUNet
    from loco_edit_tpu_torch.ops.flash_attention import route

    ffhq = write_ffhq_folder(os.path.join(work_dir, "ffhq"), image_px)
    steps, edit_t, rank, vis_num = 100, 0.2, 3, 2
    argv = ["--sh_file_name", P2_SCRIPT, "--sample_idx", "0", "--dtype", "fp32",
            "--seed", "1", "--model_name", model_name, "--dataset_name", "FFHQ",
            "--dataset_root", ffhq, "--checkpoint_path", "",
            "--mask_model_name", "facebook/sam-vit-large", "--mask_type", "SAM",
            "--for_steps", str(steps), "--inv_steps", str(steps),
            "--use_yh_custom_scheduler", "true", "--x_space_guidance_edit_step", "1",
            "--x_space_guidance_scale", "12.0", "--x_space_guidance_num_step", "1",
            "--edit_t", str(edit_t), "--performance_boosting_t", "0.2",
            "--run_edit_null_space_projection", "true", "--note", "Uncond",
            "--null_space_projection", "true", "--pca_rank_null", "5",
            "--pca_rank", str(rank), "--mask_index", "0", "--vis_num", str(vis_num),
            "--device", "cuda", "--result_folder", os.path.join(work_dir, "runs"),
            "--mask_backend", "flax"]
    masks = sam_sampling_run("12 p2 sam", cli_main, argv, image_px)
    edit_argv = argv + ["--sampling_mode", "false"]
    log(f"[12 p2 sam] python -m loco_edit_tpu_torch.cli.main {' '.join(edit_argv)}; "
        f"cut: {P2_SAM_CUTS}")
    dtypes = set()
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, a: dtypes.add(a[0].dtype) if isinstance(m, ADMUNet) else None)
    config = pipelines.UncondEditConfig
    pipelines.UncondEditConfig = functools.partial(
        config, min_iter=P2_SAM_SWEEPS, max_iter=P2_SAM_SWEEPS)
    try:
        res, launches, fwd, total_s, peak = run_main_path(lambda: cli_main(edit_argv), ADMUNet)
    finally:
        pipelines.UncondEditConfig = config
        hook.remove()
    fwd = fwd["ADMUNet"]
    out = res["edit"]
    t_idx = out["edit_t_idx"]
    fixed = (steps - 2) + t_idx + (steps - 1 - t_idx)   # invert + generate + strips
    # ranks 3 and 5 differ, so the mask and null bases run one after the
    # other, each 1 primal + one per sweep
    basis_fwd = fwd - fixed
    vT = out["vT"]
    norms = np.linalg.norm(vT, axis=1)
    files = sorted(os.listdir(out["out_dir"])) + sorted(
        os.listdir(os.path.join(out["out_dir"], "basis", f"local_basis-{edit_t}T")))
    frames = 3   # x-space guidance of 1 step: frames -1, 0 and +1 whatever vis_num
    checks = {
        "f32": dtypes == {torch.float32},
        "xt_finite": bool(np.isfinite(out["xt"]).all()),
        "vT_shape": list(vT.shape) == [rank, image_px * image_px * 3],
        "vT_finite": bool(np.isfinite(vT).all()),
        "vT_unit_norm": bool(np.abs(norms - 1).max() < 1e-4),
        "strips": sorted(out["strips"]) == list(range(rank)) and all(
            s.shape == (frames, image_px, image_px, 3) and np.isfinite(s).all()
            for s in out["strips"].values()),
        "pngs": sum(f.startswith("edit-") and f.endswith(".png") for f in files) == rank,
        "npz": all(f"pc_{i:03d}-vT.npz" in files for i in range(rank))
        and sum(f.startswith("vT-") and f.endswith(".npz") for f in files) == 2,
        "sweeps": basis_fwd == 2 * (1 + P2_SAM_SWEEPS),
    }
    phases = {k: round(v, 3) for k, v in res["timings"]["edit"].items()}
    log(f"[12 p2 sam] f32 edit with SAM mask 0 ({masks[0, ..., 0].mean():.3f} of pixels): "
        f"{total_s:.2f} s total (model build and dataset included); phases (s) {phases}; "
        f"peak device memory {peak:.2f} GiB; {fwd} P2 forwards ({basis_fwd} in the two bases), "
        f"routes GroupNorm vec16-two-launch f32, attention {route(torch.float32, 64)}; "
        f"launches {launches}; checks {checks}; |vT| rows {norms.round(6).tolist()}")
    if not all(checks.values()):
        fail(f"FFHQ_P2 SAM script checks failed: {checks}")
    _, n_gn, n_attn, _ = MODELS["P2"]
    predicted = {"groupnorm": n_gn * fwd, "flash_attention": n_attn * fwd}
    if launches != predicted:
        fail(f"FFHQ_P2 SAM script launches {launches} != predicted {predicted}: a path "
             "went around a kernel or launched it more than once per forward")
    return launches


# -- phase 13: the port's edit server ------------------------------------------

# GN and attention launches per P2 forward
P2_PER_FWD = {"ADMUNet": (65, 4)}
# the served P2 edit: 10 fixed basis sweeps (phase 4's), rank 5 + null 5
SERVE_SWEEPS = 10
SERVE_LCM_SWEEPS = 5
# LPIPS card vs CPU, relative to the larger value (full-f32 convolutions)
LPIPS_RTOL = 1e-4
# the /edit_batch image item (an image in [-1, 1]) against its own /edit,
# relative L2 of each strip, in bf16. Set from the readings 5.8e-2 and
# 6.3e-2 of two chip runs of the item and 5.2e-2 to 6.3e-2 of the
# generation alone on three images (H100 80GB HBM3, 700 W): its inverted
# x_T has spikes near 16, and bf16 rounding that changes with the batch
# size moves its regeneration that far; the seeds' items stay at
# BF16_FWD_RTOL. batch_gap's f32 witness holds the same generation at f32
# to F32_BATCH_RTOL, which puts the gap in bf16 rounding.
BF16_IMAGE_ITEM_RTOL = 1e-1
F32_BATCH_RTOL = 1e-3


def http_json(url, payload=None):
    """GET (payload None) or POST a JSON request; fail unless it answers 200.
    Returns (the decoded answer, host seconds)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=900) as r:
            out = json.loads(r.read())
    except urllib.error.HTTPError as e:
        fail(f"{url} answered {e.code}: {e.read()[:500]!r}")
    return out, time.perf_counter() - t0


def b64_array(a: np.ndarray) -> str:
    import base64

    return base64.b64encode(np.ascontiguousarray(a, np.float32).tobytes()).decode()


def strips_of(out) -> dict:
    import base64

    dt = np.uint8 if out["dtype"] == "uint8" else np.float32
    return {int(pc): np.frombuffer(base64.b64decode(b), dt).reshape(out["shape"])
            for pc, b in out["strips"].items()}


def start_server(service):
    """The port's server over `service` on 127.0.0.1, port 0, in a thread."""
    import threading

    from loco_edit_tpu_torch.serve import make_server

    srv = make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def trace_busy_share(path: str) -> dict:
    """Read a utils/logger.py::device_trace Chrome trace: the window (its
    TRACE_WINDOW annotation), the union of the card's kernel, copy and
    memset intervals inside it, their ratio, and the program spans in it.
    Times in ms; "events" counts the device events."""
    from loco_edit_tpu_torch.utils.logger import TRACE_WINDOW

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == TRACE_WINDOW and e.get("ph") == "X"]
    w0 = min(float(e["ts"]) for e in win)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in win)
    spans = sorted((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0)), w1))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    spans = [s for s in spans if s[1] > s[0]]
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    window_ms, busy_ms = (w1 - w0) / 1e3, busy / 1e3
    return {"window_ms": window_ms, "busy_ms": busy_ms,
            "share": busy_ms / window_ms if window_ms > 0 else 0.0, "events": len(spans),
            "spans": sum(e.get("cat") == "loco_span" for e in events)}


def served(tag, what, url, payload, model_classes, per_forward, predicted_fwd, svc):
    """One request on the main path (run_main_path's counts), its forwards and
    launches held to predicted_fwd x per_forward; prints the host seconds,
    the server's secs, edits_served and the peak memory. Returns (answer,
    launches)."""
    out, launches, fwd, host_s, peak = run_main_path(lambda: http_json(url, payload)[0],
                                                     *model_classes)
    log(f"[{tag}] {what}: host {host_s:.3f} s, server secs {out.get('secs')}, "
        f"edits_served {svc.edits_served}, peak device memory {peak:.2f} GiB")
    check_t2i_launches(tag, what, launches, fwd, predicted_fwd, per_forward)
    return out, launches


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def write_lpips_checkpoint(path: str, net: str = "alex", seed: int = 0) -> str:
    """A seeded LPIPS state_dict in the lpips package's naming, written to
    path."""
    from loco_edit_tpu_torch.utils.lpips import LPIPS, lpips_package_state_dict

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in LPIPS(net).state_dict().items():
        if k.endswith(".weight"):     # a backbone conv: He-normal
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith(".bias"):
            sd[k] = torch.randn(v.shape, generator=g) * 0.05
        else:                         # a lin head
            sd[k] = torch.rand(v.shape, generator=g)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(lpips_package_state_dict(sd, net), path)
    return path


def batch_gap(pipe, xT, others, t_idx):
    """How far the generation of xT to edit_t moves when it runs behind
    `others` (as /edit_batch batches them) against alone (as /edit runs
    it): the relative L2 of its x_{edit_t} (all that follows runs at batch
    1 in both)."""
    alone = pipe.generate(xT, 0, t_idx)
    batched = pipe.generate(torch.cat([*others, xT]), 0, t_idx)[-1:]
    return float((batched - alone).norm() / alone.norm())


def phase_serve_p2(work_dir, model_name="FFHQ_P2", device="cuda"):
    """Phase 13, P2: the port's server (serve.py's EditService behind
    make_server) on the full-width FFHQ_P2 with seeded bf16 weights at the
    reference's 100/100 steps, rank 5 + null 5, SERVE_SWEEPS fixed sweeps,
    answering /health, /edit (uint8), the same /edit again (the cached
    basis, the same bits), /edit_batch of seeds and an image in [-1, 1]
    (each item against its own /edit; the image's batch gap witnessed at
    f32 by batch_gap), /invert (timed under the server's own flags, then
    against pipe.invert on the service's device thread with deterministic
    cuDNN, the same bits), /segment
    (seeded SAM ViT-L), and one /edit under device_trace (the device's busy
    share of its window); then the metrics and LPIPS of the served strips,
    card against CPU. Returns the launches of every request."""
    import argparse

    from loco_edit_tpu_torch.cli.args import parse_args, preset
    from loco_edit_tpu_torch.core.rng import seed_everything
    from loco_edit_tpu_torch.models.adm import ADMUNet
    from loco_edit_tpu_torch.models.registry import load_denoiser
    from loco_edit_tpu_torch.pipelines import UncondEditPipeline
    from loco_edit_tpu_torch.serve import EditService
    from loco_edit_tpu_torch.utils import metrics
    from loco_edit_tpu_torch.utils.io import to_uint8
    from loco_edit_tpu_torch.utils.logger import device_trace
    from loco_edit_tpu_torch.utils.lpips import LPIPSMetric

    tag = "13 serve p2"
    argv = ["--model_name", model_name, "--dataset_name", "Random", "--dtype", "bf16",
            "--device", device, "--for_steps", "100", "--inv_steps", "100",
            "--edit_t", "0.6", "--performance_boosting_t", "0.2",
            "--x_space_guidance_scale", "0.5", "--x_space_guidance_num_step", "16",
            "--vis_num", "4", "--pca_rank", "5", "--pca_rank_null", "5",
            "--null_space_projection", "true", "--seed", "0",
            "--result_folder", os.path.join(work_dir, "serve_p2")]
    t0 = time.perf_counter()
    args = preset(parse_args(argv))
    svc = EditService(args)
    cfg = svc.pipe.cfg
    cfg.min_iter = cfg.max_iter = SERVE_SWEEPS
    cfg.convergence_threshold = 0.0
    srv, url = start_server(svc)
    h, w, c = svc.sample_shape
    log(f"[{tag}] python -m loco_edit_tpu_torch.serve --port 0 {' '.join(argv)}; "
        f"{SERVE_SWEEPS} fixed sweeps; service built in {time.perf_counter() - t0:.2f} s; {url}")
    box = [h // 4, 3 * h // 4, w // 4, 3 * w // 4]
    mask = np.zeros((1, h, w, c), bool)
    mask[:, box[0]:box[1], box[2]:box[3]] = True
    t_idx, steps = svc.pipe.edit_t_idx, cfg.for_steps
    strips_fwd, inv_fwd = steps - 1 - t_idx, cfg.inv_steps - 2
    fresh = {"ADMUNet": t_idx + 1 + SERVE_SWEEPS + strips_fwd}
    cached = {"ADMUNet": t_idx + strips_fwd}
    n_frames = cfg.pca_rank * (2 * cfg.vis_num + 1)
    total = {}
    try:
        health, host_s = http_json(url + "/health")
        log(f"[{tag}] /health: {health} ({host_s * 1e3:.1f} ms)")
        if health != {"ok": True, "engine": "uncond", "edits_served": 0}:
            fail(f"{tag}: /health answered {health}")

        req = {"seed": 1, "mask_bbox": box}
        answers = []
        for what, fwd in (("/edit", fresh), ("/edit again (cached basis)", cached)):
            svc.pipe._boost_calls = 0
            out, launches = served(tag, what, url + "/edit", req, (ADMUNet,), P2_PER_FWD,
                                   fwd, svc)
            add_launches(total, launches)
            answers.append(out)
        first = strips_of(answers[0])
        checks = {
            "fields": sorted(answers[0]) == ["dtype", "null_space_projection", "secs",
                                             "shape", "strips"],
            "uint8": answers[0]["dtype"] == "uint8"
            and answers[0]["shape"] == [n_frames // cfg.pca_rank, h, w, c],
            "projected": answers[0]["null_space_projection"] is True,
            "pcs": sorted(first) == list(range(cfg.pca_rank)),
            "same_bits": all(np.array_equal(first[pc], s)
                             for pc, s in strips_of(answers[1]).items()),
        }
        log(f"[{tag}] /edit: server secs {answers[0]['secs']} fresh, {answers[1]['secs']} "
            f"with the cached basis; checks {checks}")
        if not all(checks.values()):
            fail(f"{tag}: /edit checks failed: {checks}")

        # the image item: phase 4's input image, in [-1, 1]
        x0 = np.clip(np.random.default_rng(2).normal(size=(1, h, w, c)) * 0.5, -1,
                     1).astype(np.float32)
        items = [{"seed": 2 + i, "mask_bbox": box} for i in range(SERVE_P2_ITEMS - 1)]
        items.append({"image": b64_array(x0), "mask_bbox": box})
        svc.pipe._boost_calls = 0
        batch, launches = served(
            tag, f"/edit_batch ({len(items) - 1} seeds + 1 image)", url + "/edit_batch",
            {"items": items, "pixel": False}, (ADMUNet,), P2_PER_FWD,
            {"ADMUNet": inv_fwd + t_idx + len(items) * (1 + SERVE_SWEEPS + strips_fwd)}, svc)
        add_launches(total, launches)
        errs = []
        for i, it in enumerate(items):
            svc.pipe._boost_calls = i           # the noise stream of its batch place
            single, launches = served(
                tag, f"/edit of batch item {i}", url + "/edit", dict(it, pixel=False),
                (ADMUNet,), P2_PER_FWD,
                {"ADMUNet": (inv_fwd if "image" in it else 0) + t_idx + strips_fwd}, svc)
            add_launches(total, launches)
            got, ref = strips_of(batch["results"][i]), strips_of(single)
            errs.append(max(float(np.linalg.norm(got[pc] - ref[pc]) / np.linalg.norm(ref[pc]))
                            for pc in ref))
        tols = [BF16_IMAGE_ITEM_RTOL if "image" in it else BF16_FWD_RTOL for it in items]
        log(f"[{tag}] /edit_batch items against their /edit (relative L2, each strip): "
            f"{[f'{e:.2e}' for e in errs]}, limits {[f'{t:.0e}' for t in tols]}; batch "
            f"server secs {batch['secs']}")
        if not (batch["null_space_projection"] and all(e <= t for e, t in zip(errs, tols))):
            fail(f"{tag}: /edit_batch items disagree with /edit: {errs}, limits {tols}")

        # the image item's batch gap in the server's bf16 and at f32, from
        # the x_T the server inverts it to
        t1 = time.perf_counter()
        others = [torch.from_numpy(svc._resolve_input(it)[1]).to(device) for it in items[:-1]]
        xT_image = svc.pipe.invert(x0)
        gaps = {"bf16": batch_gap(svc.pipe, xT_image, others, t_idx)}
        with tf32_convs(False):
            den32 = load_denoiser(argparse.Namespace(**{**vars(args), "dtype": "fp32"}))
            pipe32 = UncondEditPipeline(den32, dataclasses.replace(
                cfg, result_folder=os.path.join(work_dir, "witness")),
                seed_everything(0), device=device)
            gaps["f32"] = batch_gap(pipe32, xT_image, others, t_idx)
        del den32, pipe32
        log(f"[{tag}] the image item's generation to edit_t behind {len(others)} seeds "
            f"against alone, relative L2 of x_edit_t (max |x_T| "
            f"{float(xT_image.abs().max()):.3f}): {gaps}; limit at f32 {F32_BATCH_RTOL:.0e}; "
            f"{time.perf_counter() - t1:.2f} s")
        if not gaps["f32"] <= F32_BATCH_RTOL:
            fail(f"{tag}: at f32 the image's generation depends on its batch: {gaps}")

        inv_s, launches = served(tag, "/invert (the server's own cuDNN flags)",
                                 url + "/invert", {"image": b64_array(x0)}, (ADMUNet,),
                                 P2_PER_FWD, {"ADMUNet": inv_fwd}, svc)
        add_launches(total, launches)
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            inv, launches = served(tag, "/invert (deterministic cuDNN, the compared pair)",
                                   url + "/invert", {"image": b64_array(x0)}, (ADMUNet,),
                                   P2_PER_FWD, {"ADMUNet": inv_fwd}, svc)
            add_launches(total, launches)
            # on the service's device thread, where /invert ran: cuDNN keeps
            # the algorithms it measured per thread (core/device.py)
            ref = svc.on_device(svc.pipe.invert, x0).cpu().numpy()
        finally:
            torch.backends.cudnn.deterministic = saved
        import base64

        xT = np.frombuffer(base64.b64decode(inv["xT"]), np.float32).reshape(inv["shape"])
        log(f"[{tag}] /invert: shape {inv['shape']}, max |xT| {float(np.abs(xT).max()):.3f}, "
            f"the same bits as pipe.invert: {np.array_equal(xT, ref)} (max |diff| "
            f"{float(np.abs(xT - ref).max()):.2e})")
        if not (np.array_equal(xT, ref) and inv_s["shape"] == inv["shape"]):
            fail(f"{tag}: /invert differs from pipe.invert on the same input")

        seg, launches = served(tag, "/segment (seeded SAM ViT-L)", url + "/segment",
                               {"image": b64_array(x0)}, (ADMUNet,), P2_PER_FWD,
                               {"ADMUNet": 0}, svc)
        t = svc._sam.timings
        log(f"[{tag}] /segment: masks {seg['shape']}; encode {t['encode'] * 1e3:.1f} ms, "
            f"decode {t['decode'] * 1e3:.1f} ms over {t['decode_batches']} batches, host "
            f"filters {t['filter'] * 1e3:.1f} ms, {t['kept']} kept of {t['candidates']}")
        if not (len(seg["shape"]) == 3 and seg["shape"][1:] == [h, w] and seg["shape"][0] >= 1):
            fail(f"{tag}: /segment answered masks of shape {seg['shape']}")

        trace_dir = os.path.join(work_dir, "trace")
        svc.pipe._boost_calls = 0
        with device_trace(trace_dir, cuda=device == "cuda"):
            traced, launches = served(tag, "/edit under device_trace", url + "/edit", req,
                                      (ADMUNet,), P2_PER_FWD, cached, svc)
        add_launches(total, launches)
        path = os.path.join(trace_dir, "trace.json")
        busy = trace_busy_share(path)
        log(f"[{tag}] device trace of one served /edit (cached basis): window "
            f"{busy['window_ms']:.1f} ms, device busy {busy['busy_ms']:.1f} ms in "
            f"{busy['events']} kernel/copy events: busy share {busy['share']:.3f}, idle "
            f"{1 - busy['share']:.3f}; {busy['spans']} program spans; server secs "
            f"{traced['secs']}; trace {os.path.getsize(path) / 2 ** 20:.1f} MiB")
        if device == "cuda" and not (busy["events"] > 0 and 0 < busy["share"] <= 1):
            fail(f"{tag}: the device trace holds no device work: {busy}")
        if busy["spans"] == 0:
            fail(f"{tag}: the device trace holds no program span")
    finally:
        srv.shutdown()
        srv.server_close()

    # eval of the image item's float strip (pc 0) against its original, both
    # clipped to [0, 1] as their PNGs would be
    strip = np.clip((strips_of(batch["results"][-1])[0] + 1) / 2, 0, 1)
    orig = np.repeat(np.clip((x0 + 1) / 2, 0, 1), strip.shape[0], axis=0)
    m = np.repeat(mask, strip.shape[0], axis=0)
    lp_path = write_lpips_checkpoint(os.path.join(work_dir, "lpips", "alex.pth"))
    res = {}
    with tf32_convs(False):
        for dev in (device, "cpu"):
            a = torch.from_numpy(strip).to(dev)
            b = torch.from_numpy(orig).to(dev)
            res[dev] = {
                "ssim": metrics.ssim(a, b).cpu(),
                "mse_off": metrics.masked_mse(a, b, torch.from_numpy(~m).to(dev)).cpu(),
                "mse_in": metrics.masked_mse(a, b, torch.from_numpy(m).to(dev)).cpu(),
                "lpips": LPIPSMetric.from_torch_file(lp_path, device=dev)(
                    a, b, normalize=True).cpu(),
            }
    errs = {k: rel_err(res[device][k], res["cpu"][k]) for k in res["cpu"]}
    log(f"[{tag}] eval of the image item's strip ({strip.shape[0]} frames, {h} px) against "
        f"its original, card vs CPU (relative to max |CPU|): {errs}; means on the card: "
        + ", ".join(f"{k} {float(v.mean()):.4f}" for k, v in res[device].items()))
    bad = {k: e for k, e in errs.items() if not e <= (LPIPS_RTOL if k == "lpips" else 1e-5)}
    if bad:
        fail(f"{tag}: metrics on the card disagree with the CPU: {bad}")
    del svc
    return total


def phase_serve_lcm(work_dir, model_name="LCM_Dreamshaper_v7", device="cuda"):
    """Phase 13, LCM: the port's server on the full-width LCM Dreamshaper v7
    with seeded bf16 weights (4 steps, edit_t_idx 2, w 6.5, rank 5 + null 5
    non-semantic, x-space guidance 0.4 x 24, vis_num 1, SERVE_LCM_SWEEPS
    fixed sweeps): one /edit with "pixel" true timed under the server's own
    flags, then the compared pair with deterministic cuDNN: the same request
    with "pixel" true and false; the uint8 strip must be to_uint8 of the
    float strip. Returns the launches."""
    from loco_edit_tpu_torch.cli.args import parse_args, preset
    from loco_edit_tpu_torch.models.sd import SDUNet, VAEDecoder, VAEEncoder
    from loco_edit_tpu_torch.serve import EditService
    from loco_edit_tpu_torch.utils.io import to_uint8

    tag = "13 serve lcm"
    argv = ["--model_name", model_name, "--dataset_name", "Random", "--dtype", "bf16",
            "--device", device, "--guidance_scale", "7.5", "--num_inference_steps", "4",
            "--edit_t_idx", "2", "--x_space_guidance_scale", "0.4",
            "--x_space_guidance_num_step", "24", "--pca_rank", "5", "--pca_rank_null", "5",
            "--non_semantic", "true", "--null_space_projection", "true", "--vis_num", "1",
            "--use_yh_custom_scheduler", "false", "--seed", "0",
            "--result_folder", os.path.join(work_dir, "serve_lcm")]
    t0 = time.perf_counter()
    svc = EditService(preset(parse_args(argv)))
    cfg = svc.pipe.cfg
    cfg.min_iter = cfg.max_iter = SERVE_LCM_SWEEPS
    srv, url = start_server(svc)
    px = svc.mask_shape[1]
    log(f"[{tag}] python -m loco_edit_tpu_torch.serve --port 0 {' '.join(argv)}; "
        f"{SERVE_LCM_SWEEPS} fixed sweeps; service built in {time.perf_counter() - t0:.2f} s; "
        f"mask space {svc.mask_shape} (from the decoder's configuration)")
    req = {"seed": 0, "for_prompt": LCM_PROMPTS[0], "semantic": False, "sample_name": "lcm",
           "mask_bbox": [px // 4, 3 * px // 4, px // 4, 3 * px // 4]}
    n_frames = 2 * cfg.vis_num + 1
    chunks = -(-n_frames // cfg.memory_bound)
    steps_left = len(svc.pipe.grid) - cfg.edit_t_idx
    fwd = {"SDUNet": cfg.edit_t_idx + 1 + SERVE_LCM_SWEEPS + chunks * steps_left,
           "VAEDecoder": 1 + SERVE_LCM_SWEEPS + chunks, "VAEEncoder": 0}
    total, answers = {}, []
    saved = torch.backends.cudnn.deterministic
    try:
        for what, pixel, det in (("the server's own cuDNN flags", True, saved),
                                 ("deterministic cuDNN", True, True),
                                 ("deterministic cuDNN", False, True)):
            torch.backends.cudnn.deterministic = det
            svc.pipe._noise_calls = 0       # the same inter-step noise every time
            out, launches = served(tag, f"/edit pixel {str(pixel).lower()} ({what})",
                                   url + "/edit", dict(req, pixel=pixel),
                                   (SDUNet, VAEDecoder, VAEEncoder), SD_PER_FWD, fwd, svc)
            add_launches(total, launches)
            answers.append(out)
    finally:
        torch.backends.cudnn.deterministic = saved
        srv.shutdown()
        srv.server_close()
    fast, u8, f32 = (strips_of(a)[0] for a in answers)
    ref = to_uint8(f32)
    checks = {"uint8": answers[0]["dtype"] == answers[1]["dtype"] == "uint8"
              and fast.shape == u8.shape == (n_frames, px, px, 3),
              "float": answers[2]["dtype"] == "float32" and bool(np.isfinite(f32).all()),
              "projected": all(a["null_space_projection"] is True for a in answers),
              "pixel_output": np.array_equal(u8, ref)}
    log(f"[{tag}] the device's uint8 strip against to_uint8 of the float strip: "
        f"{int((u8 != ref).sum())} of {u8.size} values differ; checks {checks}")
    if not all(checks.values()):
        fail(f"{tag}: LCM pixel_output checks failed: {checks}")
    del svc
    return total


def phase_verify_all(root, device="cuda"):
    """Phase 13, --verify_load all over a directory of seeded checkpoints
    (phase 10's IF-I-M and IF-II-M, a seeded LPIPS): every file classified,
    converted with full key coverage and run forward (finite) on the card."""
    import argparse

    from loco_edit_tpu_torch.cli.verify_load import verify_checkpoint

    write_lpips_checkpoint(os.path.join(root, "lpips", "alex.pth"))
    t0 = time.perf_counter()
    rep = verify_checkpoint(argparse.Namespace(
        verify_load="all", checkpoint_path=root, model_name="", no_oracle=False,
        device=device))
    fams = {os.path.relpath(r["checkpoint"], root): (r.get("family"), r.get("ok"),
                                                     r.get("params"), r.get("forward"))
            for r in rep["reports"]}
    log(f"[13 verify_all] {time.perf_counter() - t0:.1f} s over {rep['found']} files: {fams}")
    want = {"if_stage1.pt": "ifm", "if_stage2.pt": "ifm", os.path.join("lpips", "alex.pth"):
            "lpips"}
    if not (rep["ok"] and {k: v[0] for k, v in fams.items()} == want):
        fail(f"13 verify_all: {rep}")
    return rep


# -- phase 14: training and the toolkit on FFHQ_P2 ------------------------------

P2_PARAMS = 93_563_910
# the training run: bf16 network, f32 masters, batch 8 in 2 microbatches of
# 4, loss-aware timesteps; a checkpoint at step 10, then a resumed second call
TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS, TRAIN_RESUME_AT = 8, 2, 20, 10
TRAIN_IMAGES = 16
# h-space: the encoder pullback at 0.6 T, rank 5, fixed sweeps; global PCA
# over a population in chunks; local PCA over probes (one batch)
HSPACE_T, HSPACE_RANK, HSPACE_SWEEPS = 0.6, 5, 10
PCA_POP, PCA_CHUNK, PCA_PROBES = 32, 8, 64
# likelihood and ancestral sampling over a respaced schedule (the cut: 100
# of the 1000 training steps); sampling at batch 4
RESPACED_STEPS, SAMPLE_BATCH = 100, 4


def write_train_folder(root, n=TRAIN_IMAGES, size=256):
    """n seeded face-like images (write_ffhq_folder's picture at n seeds),
    one subfolder each, for the training loader."""
    for i in range(n):
        write_ffhq_folder(os.path.join(root, f"{i:02d}"), size, seed=100 + i)
    return root


def train_step_on(model, x0, t, noise, names):
    """One f32 train step of `model` (TrainConfig's defaults) on its device:
    (metrics, the averaged gradients of the parameters named with one of
    the prefixes `names`, as its optimizer received them), on the CPU."""
    from loco_edit_tpu_torch.diffusion import NoiseSchedule
    from loco_edit_tpu_torch.training import TrainConfig, create_train_state, make_train_step

    cfg = TrainConfig()
    state = create_train_state(dict(model.named_parameters()), cfg)
    seen = {}
    inner = state.opt_state.step

    def capture(params, grads, grad_norm):
        seen.update({k: g.cpu() for k, g in zip(params, grads) if k.startswith(names)})
        inner(params, grads, grad_norm)

    state.opt_state.step = capture
    dev = next(model.parameters()).device
    _, met = make_train_step(model, cfg, NoiseSchedule.linear())(
        state, x0.to(dev), t.to(dev), torch.ones(len(t), device=dev), noise=noise.to(dev))
    return {k: v.cpu() for k, v in met.items()}, seen


def phase_train_vs_cpu(model_name="FFHQ_P2"):
    """14.1: one f32 train step at batch 1 on the card (kernels) and on the
    CPU (plain versions), the same weights, x0, t and injected noise, under
    full f32: loss, grad_norm and the gradients of the input_0, middle and
    out_conv weights held to FWD_RTOL (relative to the largest value)."""
    from loco_edit_tpu_torch.models.registry import load_adm_denoiser

    model = load_adm_denoiser(model_name, dtype=torch.float32, device="cuda",
                              seed=0).meta["model"]
    n_params = sum(p.numel() for p in model.parameters())
    if model_name == "FFHQ_P2" and n_params != P2_PARAMS:
        fail(f"FFHQ_P2 has {n_params} parameters, expected {P2_PARAMS}")
    with torch.device("cpu"):
        cpu_model = type(model)(model.cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_model.requires_grad_(False).eval()
    px = model.cfg.image_size
    rng = np.random.default_rng(21)
    x0 = torch.from_numpy(np.tanh(rng.normal(size=(1, px, px, 3))).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=(1, px, px, 3)).astype(np.float32))
    t = torch.tensor([600])
    names = ("input_0.", "middle.", "out_conv.")
    t0 = time.perf_counter()
    cpu_met, cpu_g = train_step_on(cpu_model, x0, t, noise, names)
    cpu_s = time.perf_counter() - t0
    with tf32_convs(False):
        t0 = time.perf_counter()
        met, g = train_step_on(model, x0, t, noise, names)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    errs = {k: rel_err(met[k], cpu_met[k]) for k in ("loss", "grad_norm")}
    for prefix in names:
        keys = sorted(k for k in cpu_g if k.startswith(prefix))
        errs[f"grad {prefix}*"] = rel_err(torch.cat([g[k].reshape(-1) for k in keys]),
                                          torch.cat([cpu_g[k].reshape(-1) for k in keys]))
    finite = all(torch.isfinite(v).all() for v in [*met.values(), *g.values()])
    log(f"[14 train] {model_name} ({n_params:,} parameters) f32 train step at batch 1, "
        f"card vs CPU: loss {float(met['loss']):.6f} (CPU {float(cpu_met['loss']):.6f}), "
        f"grad_norm {float(met['grad_norm']):.6f} (CPU {float(cpu_met['grad_norm']):.6f}); "
        f"relative errors {({k: f'{v:.2e}' for k, v in errs.items()})}, tol {FWD_RTOL:.0e}; "
        f"card {card_s:.2f} s, CPU {cpu_s:.2f} s")
    bad = {k: v for k, v in errs.items() if not v <= FWD_RTOL}
    if bad or not finite:
        fail(f"f32 train step card vs CPU: {bad}, finite {finite}")
    return errs


def phase_train_p2(work_dir, model_name="FFHQ_P2", device="cuda"):
    """14.2: run_training of the bf16 P2 with f32 masters over
    ShardedImageLoader: TRAIN_RESUME_AT steps with a checkpoint, then a second
    call that resumes from it and reaches TRAIN_STEPS. Each step is timed
    (synchronized). Returns (launches, the trained model)."""
    from loco_edit_tpu_torch.models.adm import ADMUNet
    from loco_edit_tpu_torch.models.registry import load_adm_denoiser
    from loco_edit_tpu_torch.training import TrainConfig, loop
    from loco_edit_tpu_torch.training.checkpoint import latest_step
    from loco_edit_tpu_torch.training.data import ShardedImageLoader
    from loco_edit_tpu_torch.utils.logger import Logger

    model = load_adm_denoiser(model_name, dtype=torch.bfloat16, device=device,
                              seed=0).meta["model"]
    px = model.cfg.image_size
    loader = ShardedImageLoader(write_train_folder(os.path.join(work_dir, "train"), size=px),
                                TRAIN_BATCH, px, seed=0, device=device)
    data = iter(loader)
    cfg = TrainConfig(microbatches=TRAIN_MICRO)
    ckpt = os.path.join(work_dir, "ckpt")
    rows, step_s = [], []

    class Recorder(Logger):
        def dumpkvs(self):
            out = super().dumpkvs()
            rows.append(out)
            return out

    make = loop.make_train_step

    def timed(*a, **k):
        fn = make(*a, **k)

        def step(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out

        return step

    def train(total):
        return loop.run_training(
            model, data, cfg=cfg, total_steps=total, log_interval=1,
            save_interval=TRAIN_RESUME_AT, ckpt_dir=ckpt, loss_aware=True, seed=0,
            logger=Recorder(formats=()), device=device)

    def run():
        first = train(TRAIN_RESUME_AT).step
        saved = latest_step(ckpt)
        return first, saved, train(TRAIN_STEPS).step, latest_step(ckpt)

    why = ""
    if loader.decoder == "pil":      # the host decoder: JAX's loader falls back the same way
        from loco_edit_tpu_torch import native

        why = f" (native: {(native._build_error or '').strip().splitlines()[:1]})"
    log(f"[14 train] {model_name} bf16 network, f32 masters: batch {TRAIN_BATCH} in "
        f"{TRAIN_MICRO} microbatches, loss-aware timesteps, {TRAIN_STEPS} steps, a checkpoint "
        f"at {TRAIN_RESUME_AT} and a resumed second call; data: {len(loader.files)} "
        f"{px} px images, decoder {loader.decoder}{why}")
    loop.make_train_step = timed
    try:
        res, launches, fwd, total_s, peak = run_main_path(run, ADMUNet)
    finally:
        loop.make_train_step = make
    losses = [r["loss"] for r in rows]
    med = float(np.median(step_s))
    checks = {"steps": res == (TRAIN_RESUME_AT, TRAIN_RESUME_AT, TRAIN_STEPS, TRAIN_STEPS),
              "logged": len(rows) == TRAIN_STEPS and all("loss_q0" in r or "loss_q1" in r
                                                         or "loss_q2" in r or "loss_q3" in r
                                                         for r in rows),
              "finite": bool(np.isfinite(losses).all()
                             and np.isfinite([r["grad_norm"] for r in rows]).all()),
              "model_back_in_eval": not model.training}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    log(f"[14 train] {total_s:.2f} s for {TRAIN_STEPS} steps (checkpoints included); step "
        f"median {1e3 * med:.1f} ms (first {1e3 * step_s[0]:.1f} ms), {TRAIN_BATCH / med:.2f} "
        f"images/s; peak device memory {peak:.2f} GiB; loss first {losses[0]:.5f} last "
        f"{losses[-1]:.5f}; launches per step {per_step} (held to {TRAIN_MICRO} x (65, 4): "
        f"the backward launches none); checks {checks}")
    if not all(checks.values()):
        fail(f"training checks failed: {checks}")
    check_t2i_launches("14 train", "run_training", launches, fwd,
                       {"ADMUNet": TRAIN_STEPS * TRAIN_MICRO}, P2_PER_FWD)
    return launches, model


def _unit_rows(a) -> bool:
    a = torch.as_tensor(a).float()
    return bool(torch.isfinite(a).all()) and float((a.norm(dim=1) - 1).abs().max()) < 1e-3


def phase_hspace_p2(model, device="cuda"):
    """14.3: the h-space toolkit on the trained bf16 model at 0.6 T: the
    encoder pullback (rank HSPACE_RANK, HSPACE_SWEEPS fixed sweeps), h_to_e
    and inv_jac on its directions, global PCA over PCA_POP draws in chunks of
    PCA_CHUNK, local PCA over PCA_PROBES probes. Returns the launches."""
    from loco_edit_tpu_torch.core.rng import RngStream
    from loco_edit_tpu_torch.diffusion import LinspaceDDIM
    from loco_edit_tpu_torch.editing import hspace
    from loco_edit_tpu_torch.models.adm import ADMUNet

    px = model.cfg.image_size
    sched = LinspaceDDIM()
    t = float(sched.generation_grid(100).t[sched.nearest_step_index(100, HSPACE_T)])
    rng = RngStream.from_seed(3)
    x = rng.fork("x").normal((1, px, px, 3), device=device)
    xs = rng.fork("population").normal((PCA_POP, px, px, 3), device=device)

    def h_fn(z):
        return model(z, t, return_h=True)[-1]

    secs, out = {}, {}

    def run():
        for name, fn in (
                ("pullback", lambda: hspace.local_encoder_pullback(
                    h_fn, x, rng.fork("probes"), rank=HSPACE_RANK, min_iter=HSPACE_SWEEPS,
                    max_iter=HSPACE_SWEEPS, tol=0.0, device=device)),
                ("h_to_e", lambda: hspace.h_to_e(
                    lambda z, u: model(z, t, h_inject=u), x, out["pullback"].u[0], device=device)),
                ("inv_jac", lambda: hspace.inv_jac(
                    h_fn, x, out["pullback"].u.reshape(HSPACE_RANK, -1), device=device)),
                ("global_pca", lambda: hspace.global_pca_h(
                    h_fn, xs, rank=HSPACE_RANK, chunk=PCA_CHUNK, device=device)),
                ("local_pca", lambda: hspace.local_pca_h(
                    h_fn, x, rng.fork("local"), rank=HSPACE_RANK, n_probes=PCA_PROBES,
                    device=device))):
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize()
            secs[name] = round(time.perf_counter() - t0, 3)

    _, launches, fwd, total_s, peak = run_main_path(run, ADMUNet)
    basis, de = out["pullback"], out["h_to_e"]
    checks = {"pullback": _unit_rows(basis.vT) and basis.iters == HSPACE_SWEEPS,
              "h_to_e": bool(torch.isfinite(de).all()) and float(de.abs().max()) > 0,
              "inv_jac": _unit_rows(out["inv_jac"]),
              "global_pca": _unit_rows(out["global_pca"][1])
              and bool(torch.isfinite(out["global_pca"][0]).all()),
              "local_pca": _unit_rows(out["local_pca"])}
    log(f"[14 hspace] t={t:.1f}: seconds {secs}; h_mid {tuple(basis.u.shape[1:])}; basis s "
        f"{basis.s.float().cpu().numpy().round(3).tolist()}; global PCA s "
        f"{out['global_pca'][0].cpu().numpy().round(2).tolist()}; |h_to_e| max "
        f"{float(de.abs().max()):.4f}; peak device memory {peak:.2f} GiB; checks {checks}")
    if not all(checks.values()):
        fail(f"h-space checks failed: {checks}")
    # pullback 1 + sweeps, h_to_e 2, inv_jac 1, global PCA one a chunk,
    # local PCA 2 (x, then the probes as one batch)
    predicted = 1 + HSPACE_SWEEPS + 2 + 1 + -(-PCA_POP // PCA_CHUNK) + 2
    check_t2i_launches("14 hspace", "h-space toolkit", launches, fwd,
                       {"ADMUNet": predicted}, P2_PER_FWD)
    return launches


def phase_bpd_ancestral_p2(model, x0, device="cuda"):
    """14.4: calc_bpd_loop with the learned sigma on one image over the
    respaced schedule (its timestep map), p_sample_scan at SAMPLE_BATCH over
    the same steps, unguided and with classifier guidance from a seeded
    EncoderADMUNet on the model's trunk (attention pool), and one
    SuperResADMUNet forward at the model's widths with doubled input
    channels. Returns the launches."""
    import dataclasses

    from loco_edit_tpu_torch.core.rng import RngStream
    from loco_edit_tpu_torch.diffusion import (GaussianDiffusionMath, NoiseSchedule,
                                               p_sample_scan, respaced_schedule)
    from loco_edit_tpu_torch.models.adm import ADMUNet
    from loco_edit_tpu_torch.models.adm.unet import AttentionBlock, GroupNorm32
    from loco_edit_tpu_torch.models.adm.variants import (EncoderADMUNet, EncoderHeadConfig,
                                                         SuperResADMUNet, classifier_grad_fn)
    from loco_edit_tpu_torch.models.base import init_random_weights_

    cfg = model.cfg
    px = cfg.image_size
    sched, tmap = respaced_schedule(NoiseSchedule.linear(), RESPACED_STEPS)
    math_ = GaussianDiffusionMath(sched)
    tt = torch.as_tensor(tmap, device=device).float()
    rng = RngStream.from_seed(4)
    with torch.device(device):
        enc = EncoderADMUNet(cfg, EncoderHeadConfig(pool="attention"))
        sr = SuperResADMUNet(dataclasses.replace(cfg, in_channels=2 * cfg.in_channels))
    for m, seed in ((enc, 7), (sr, 8)):
        init_random_weights_(m, torch.Generator(device).manual_seed(seed))
        m.requires_grad_(False).eval()
    enc_per_fwd = (sum(isinstance(m, GroupNorm32) for m in enc.modules()),
                   sum(isinstance(m, AttentionBlock) for m in enc.modules()))
    y = torch.arange(SAMPLE_BATCH, device=device)
    xT = rng.fork("xT").normal((SAMPLE_BATCH, px, px, 3), device=device)
    stash = {}

    def eps_fn(z, t):      # one forward a step: eps now, the variance next
        eps, stash["frac"] = model(z, tt[t], return_sigma=True)
        return eps

    def frac_fn(z, t):
        return stash.pop("frac")

    secs, out = {}, {}

    def run():
        for name, fn in (
                ("bpd", lambda: math_.calc_bpd_loop(
                    lambda z, t: model(z, tt[t], return_sigma=True), x0, rng.fork("bpd"),
                    learned_sigma=True)),
                ("ancestral", lambda: p_sample_scan(
                    eps_fn, xT, math_, rng.fork("ancestral"), logvar_frac_fn=frac_fn,
                    device=device)),
                ("guided", lambda: p_sample_scan(
                    eps_fn, xT, math_, rng.fork("ancestral"), logvar_frac_fn=frac_fn,
                    cond_grad_fn=classifier_grad_fn(lambda z, t: enc(z, tt[t]), y),
                    guidance_scale=1.0, device=device)),
                ("superres", lambda: sr(x0, 500.0, torch.nn.functional.avg_pool2d(
                    x0.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)))):
            t0 = time.perf_counter()
            with torch.no_grad() if name == "superres" else contextlib.nullcontext():
                out[name] = fn()
            torch.cuda.synchronize()
            secs[name] = round(time.perf_counter() - t0, 3)

    _, launches, fwd, total_s, peak = run_main_path(run, ADMUNet, EncoderADMUNet)
    bpd = out["bpd"]
    shift = float((out["guided"] - out["ancestral"]).abs().max())
    checks = {"bpd": bool(torch.isfinite(bpd["total_bpd"]).all())
              and tuple(bpd["vb"].shape) == (1, RESPACED_STEPS),
              "ancestral": bool(torch.isfinite(out["ancestral"]).all())
              and tuple(out["ancestral"].shape) == (SAMPLE_BATCH, px, px, 3),
              "guided": bool(torch.isfinite(out["guided"]).all()) and shift > 0,
              "superres": bool(torch.isfinite(out["superres"]).all())
              and tuple(out["superres"].shape) == (1, px, px, 3)}
    log(f"[14 bpd/ancestral] respaced {RESPACED_STEPS} of {NoiseSchedule.linear().num_train_timesteps} "
        f"steps (the cut); seconds {secs}; total_bpd {bpd['total_bpd'].cpu().numpy().round(4).tolist()} "
        f"(prior {bpd['prior_bpd'].cpu().numpy().round(6).tolist()}); sample range "
        f"[{float(out['ancestral'].min()):.3f}, {float(out['ancestral'].max()):.3f}]; guidance moved "
        f"the samples by up to {shift:.4f}; encoder {enc_per_fwd[0]} GN + {enc_per_fwd[1]} "
        f"attention a forward; peak device memory {peak:.2f} GiB; checks {checks}")
    if not all(checks.values()):
        fail(f"likelihood / sampling checks failed: {checks}")
    # bpd one a step, unguided and guided one a step (the variance shares
    # it), SuperRes one; the encoder one a guided step
    check_t2i_launches("14 bpd/ancestral", "bpd, sampling, SuperRes", launches, fwd,
                       {"ADMUNet": 3 * RESPACED_STEPS + 1, "EncoderADMUNet": RESPACED_STEPS},
                       {**P2_PER_FWD, "EncoderADMUNet": enc_per_fwd})
    return launches


def phase_train_and_toolkit(work_dir, model_name="FFHQ_P2", device="cuda"):
    """Phase 14. Returns {path: launches} for the kernels line."""
    phase_train_vs_cpu(model_name)
    gc.collect()
    torch.cuda.empty_cache()
    train, model = phase_train_p2(work_dir, model_name, device)
    model.requires_grad_(False).eval()
    hs = phase_hspace_p2(model, device)
    from PIL import Image

    img = np.asarray(Image.open(os.path.join(work_dir, "train", "00", "00000.png")), np.float32)
    x0 = torch.from_numpy(img / 127.5 - 1.0)[None].to(device)
    return {"train_p2": train, "hspace_p2": hs,
            "bpd_ancestral_p2": phase_bpd_ancestral_p2(model, x0, device)}


# -- phase 15: the mesh and parallel modules, two ranks on the one card ----------

P15_WORLD = 2
P15_TIMEOUT_S = 600          # each join; a rank that fails or hangs fails the phase
P15_TRAIN_STEPS, P15_BF16_STEPS, P15_BATCH = 2, 4, 8     # P15_BATCH: the global batch
P15_RANK, P15_SWEEPS, P15_FRAMES = 5, 5, 8
# the strips: generation from edit_t 0.25 of 100 steps, the last 20 boosted
# (t < 0.2); the cut (PR 10's bf16 strips ran from 0.6) keeps f32 in budget
P15_STRIP_EDIT_T = 0.25
P15_TRAIN_RTOL = 1e-4        # loss, grad_norm, checksum: ranks vs one process
P15_OVERLAP = 0.999          # basis: mean squared principal cosine per group


def _p15_denoiser(dtype, device):
    from loco_edit_tpu_torch.models.registry import load_adm_denoiser

    return load_adm_denoiser("FFHQ_P2", dtype=dtype, device=device, seed=0)


def _p15_counted(name, fn, out):
    """fn() with every kernel's launch count set to 0 just before and read
    just after (out["launches"][name]); the call shapes recorded."""
    from loco_edit_tpu_torch.ops import groupnorm as gn
    from loco_edit_tpu_torch.ops.flash_attention import flash_attention_cuda

    counted = (("groupnorm", gn.group_norm_cuda), ("flash_attention", flash_attention_cuda),
               ("groupnorm_sums", gn.group_norm_sums_cuda),
               ("groupnorm_apply", gn.group_norm_apply_cuda))
    sums_fn, apply_fn = gn.group_norm_sums_cuda, gn.group_norm_apply_cuda
    gn.group_norm_sums_cuda = _Recorder(sums_fn, lambda x, num_groups=32: call_key(
        "groupnorm_sums", x.dtype, x.shape))
    gn.group_norm_apply_cuda = _Recorder(
        apply_fn, lambda x, sums, n, scale, bias, num_groups=32, eps=1e-5: call_key(
            "groupnorm_apply", x.dtype, x.shape, eps))
    try:
        with recording_calls():
            for _, f in counted:
                f.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            out["seconds"][name] = time.perf_counter() - t0
            out["launches"][name] = {k: f.launches for k, f in counted}
    finally:
        gn.group_norm_sums_cuda, gn.group_norm_apply_cuda = sums_fn, apply_fn
    return res


class _NeighbourRows:
    """The planted fault of phase 15's strips check: a stream whose draws
    come back with the batch's shares rotated by one, as if each of `world`
    ranks had taken its neighbour's rows of the boosted tail's eta noise."""

    def __init__(self, stream, world):
        self.stream, self.world = stream, world

    def fork(self, name):
        return _NeighbourRows(self.stream.fork(name), self.world)

    def at_step(self, step):
        return _NeighbourRows(self.stream.at_step(step), self.world)

    def normal(self, shape, *, device, dtype=torch.float32):
        x = self.stream.normal(shape, device=device, dtype=dtype)
        return x.roll(shape[0] // self.world, dims=0)


def p15_paths(sharded: bool, work_dir: str, device="cuda", world=P15_WORLD) -> dict:
    """Phase 15's paths on FFHQ_P2 at full width, over meshes of `world`
    ranks (sharded) or in one process: f32 data-parallel train steps, bf16
    ones, the probe-sharded f32 rank 5+5 basis, the data-sharded f32 strips
    (in one process also with the planted fault, uncounted) and the
    spatially split f32 forward and J.v. Returns numpy results, the
    launches of each path and the seconds it took."""
    from loco_edit_tpu_torch.core.mesh import DATA_AXIS, PROBE_AXIS, make_mesh
    from loco_edit_tpu_torch.core.rng import RngStream
    from loco_edit_tpu_torch.diffusion import LinspaceDDIM, NoiseSchedule
    from loco_edit_tpu_torch.editing import dual_subspace_iteration
    from loco_edit_tpu_torch.editing.pullback import pmp_pullback_fn
    from loco_edit_tpu_torch.parallel.checks import replicated_params_checksum
    from loco_edit_tpu_torch.parallel.sp import make_sp_mesh, sp_denoiser
    from loco_edit_tpu_torch.pipelines import UncondEditConfig, UncondEditPipeline
    from loco_edit_tpu_torch.training import (TrainConfig, UniformSampler,
                                              create_train_state, make_train_step)

    out = {"launches": {}, "seconds": {}}
    n = world if sharded else 1
    rank = 0
    if sharded:
        import torch.distributed as dist

        rank = dist.get_rank()
    rng = np.random.default_rng(31)
    den = _p15_denoiser(torch.float32, device)
    px = den.sample_shape[0]
    x0 = torch.from_numpy(np.tanh(rng.normal(size=(P15_BATCH, px, px, 3))).astype(np.float32))
    b = P15_BATCH // n
    x0_mine = x0[rank * b:(rank + 1) * b].to(device)

    # one microbatch a rank, and as many of the same size in one process:
    # the kernels see the same batch; the global noise is drawn once from
    # the step's stream
    micro = 1 if sharded else world

    def train_f32():
        model = _p15_denoiser(torch.float32, device).meta["model"]
        mesh = make_mesh({DATA_AXIS: n}) if sharded else None
        cfg = TrainConfig(microbatches=micro)
        state = create_train_state(model, cfg, mesh=mesh)
        step = make_train_step(model, cfg, NoiseSchedule.linear(), mesh=mesh)
        root, sampler, mets = RngStream.from_seed(5), UniformSampler(1000), []
        for s in range(P15_TRAIN_STEPS):
            srng = root.at_step(s)
            t, w = sampler.sample(srng, P15_BATCH)
            noise = srng.fork("noise").normal(x0.shape, device=device)
            state, met = step(state, x0_mine, t.to(device), w.to(device), noise=noise)
            mets.append({k: float(met[k]) for k in ("loss", "grad_norm")})
        return {"metrics": mets,
                "checksum": float(replicated_params_checksum(state.params))}

    def train_bf16():
        model = _p15_denoiser(torch.bfloat16, device).meta["model"]
        mesh = make_mesh({DATA_AXIS: n}) if sharded else None
        cfg = TrainConfig(microbatches=micro)
        state = create_train_state(model, cfg, mesh=mesh)
        step = make_train_step(model, cfg, NoiseSchedule.linear(), mesh=mesh)
        t = torch.full((P15_BATCH,), 400, device=device)
        w = torch.ones(P15_BATCH, device=device)
        noise = RngStream.from_seed(6).normal(x0.shape, device=device)
        losses = []
        for _ in range(P15_BF16_STEPS):
            state, met = step(state, x0_mine.bfloat16(), t, w, noise=noise.bfloat16())
            losses.append(float(met["loss"]))
        return losses

    grid = LinspaceDDIM().generation_grid(100)
    idx = LinspaceDDIM().nearest_step_index(100, 0.6)
    t_edit, ab = float(grid.t[idx]), float(grid.alpha_bar[idx])
    x1 = torch.from_numpy((rng.normal(size=(1, px, px, 3)) * 0.5).astype(np.float32)).to(device)
    v1 = torch.from_numpy(rng.normal(size=(1, px, px, 3)).astype(np.float32)).to(device)

    def basis():
        m = torch.zeros(1, px, px, 3, device=device)
        m[:, px // 4:3 * px // 4, px // 4:3 * px // 4] = 1.0
        pm = make_mesh({PROBE_AXIS: n}) if sharded else None
        root = RngStream.from_seed(7)
        a, bb = dual_subspace_iteration(
            pmp_pullback_fn(den.eps_fn, ab, t_edit), x1, root.fork("a"), root.fork("b"),
            rank_a=P15_RANK, rank_b=P15_RANK, mask_a=m, mask_b=1 - m,
            min_iter=P15_SWEEPS, max_iter=P15_SWEEPS, tol=0.0, probe_mesh=pm,
            probe_chunk=None if sharded else P15_RANK)
        return [a.vT.cpu().numpy(), bb.vT.cpu().numpy()]

    def strips(rng=RngStream.from_seed(9)):
        cfg = UncondEditConfig(for_steps=100, inv_steps=100, edit_t=P15_STRIP_EDIT_T,
                               performance_boosting_t=0.2, mesh_data=n if sharded else 0,
                               result_folder=work_dir, save_images=False)
        pipe = UncondEditPipeline(den, cfg, rng, device=device)
        frames = RngStream.from_seed(10).normal((P15_FRAMES, px, px, 3), device=device)
        return pipe.generate_chunked(frames, pipe.edit_t_idx, None, boost=True).cpu().numpy()

    def spatial():
        eps = sp_denoiser(den.eps_fn, make_sp_mesh(n)) if sharded else den.eps_fn
        with torch.no_grad():
            e = eps(x1, t_edit)
        jv = torch.func.jvp(pmp_pullback_fn(eps, ab, t_edit), (x1,), (v1,))[1]
        return {"eps": e.cpu().numpy(), "jv": jv.cpu().numpy()}

    out["train_f32"] = _p15_counted("p15_train_f32", train_f32, out)
    if sharded:     # the ranks alone: the loss must fall
        out["train_bf16"] = _p15_counted("p15_train_bf16", train_bf16, out)
    out["basis"] = _p15_counted("p15_basis", basis, out)
    out["strips"] = _p15_counted("p15_strips", strips, out)
    if not sharded:
        out["strips_fault"] = strips(_NeighbourRows(RngStream.from_seed(9), world))
    out["sp"] = _p15_counted("p15_sp", spatial, out)
    return out


def _p15_rank(rank, world, port, work_dir, device, queue):
    """One rank of phase 15: start the group, run p15_paths sharded, send
    the result (or the traceback) to the parent."""
    import traceback

    try:
        import torch.distributed as dist

        from loco_edit_tpu_torch.core.mesh import initialize_distributed

        backend = initialize_distributed(f"127.0.0.1:{port}", world, rank, device=device)
        dev = torch.cuda.current_device()
        out = p15_paths(True, work_dir, device, world)
        out.update(backend=backend, device=f"cuda:{dev} {torch.cuda.get_device_name(dev)}",
                   calls=dict(MAIN_PATH_CALLS), peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        queue.put((rank, "ok", out))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:   # noqa: BLE001: the parent fails the phase with it
        queue.put((rank, "error", traceback.format_exc()))


def p15_spawn(work_dir, device, world):
    """`world` ranks, each join under P15_TIMEOUT_S; kills them on failure."""
    import multiprocessing as mp
    import queue as queue_mod
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_p15_rank, args=(r, world, port, work_dir, device, q))
             for r in range(world)]
    results = {}
    try:
        for p in procs:
            p.start()
        deadline = time.perf_counter() + P15_TIMEOUT_S
        while len(results) < world:
            left = deadline - time.perf_counter()
            if left <= 0:
                fail(f"[15 mesh] ranks {sorted(set(range(world)) - set(results))} "
                     f"did not finish in {P15_TIMEOUT_S} s")
            try:
                r, status, out = q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in results]
                if dead:
                    fail(f"[15 mesh] ranks {dead} died without a result")
                continue
            if status != "ok":
                fail(f"[15 mesh] rank {r} failed:\n{out}")
            results[r] = out
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
            if p.exitcode != 0:
                fail(f"[15 mesh] a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [results[r] for r in range(world)]


def sp_gn_rows(gn_calls, g):
    """GroupNorm's statistics and normalize entries at the half-height shapes
    spatial parallelism over two ranks gives them (batch 1, f32 and bf16):
    each against its plain version (phase 2's tolerances), timed beside its
    bound; and at every full-height shape sums -> apply must give the fused
    entry's bits (one rank)."""
    from loco_edit_tpu_torch.ops.groupnorm import (group_norm_apply_cuda,
                                                   group_norm_apply_plain, group_norm_cuda,
                                                   group_norm_sums_cuda, group_norm_sums_plain)

    rows, not_equal = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        for shape in sorted(set(gn_calls)):
            c, h, w, eps = shape
            per = gn_calls.count(shape)
            x = (torch.randn(1, h, w, c, device="cuda", generator=g) * 2 + 0.3).to(dtype)
            x = x.permute(0, 3, 1, 2)
            s = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
            bias = 0.1 * torch.randn(c, device="cuda", generator=g)
            fused = group_norm_cuda(x, s, bias, eps=eps)
            split = group_norm_apply_cuda(x, group_norm_sums_cuda(x), h * w * c // 32, s,
                                          bias, eps=eps)
            if not torch.equal(fused, split):
                not_equal.append((dt, shape))
            xh = x[:, :, :h // 2].contiguous(memory_format=torch.channels_last)
            sums = group_norm_sums_cuda(xh)
            n = (h // 2) * w * c // 32 * P15_WORLD
            full = 2 * sums            # the all-reduce over two alike bands
            plain_sums = group_norm_sums_plain(xh)
            err_s = (sums - plain_sums).abs().max().item()
            y = group_norm_apply_cuda(xh, full, n, s, bias, eps=eps)
            err_a = (y.float() - group_norm_apply_plain(xh, full, n, s, bias, eps=eps)
                     .float()).abs().max().item()
            nb = xh.numel() * xh.element_size()
            common = dict(model="P2-SP2", dtype=dt, per_forward=per, eps=None,
                          shape=[1, c, h // 2, w], route="vec16-split")
            sb, sby = bound(nb + 2 * 32 * 4, 2 * xh.numel(), "float32_fma")
            rows.append(dict(common, kernel="groupnorm_sums", max_abs_err=err_s,
                             # f32 sums: phase 2's f32 GroupNorm tolerance, relative
                             tol=TOL[("groupnorm", "float32")] * max(1.0, float(
                                 plain_sums.abs().max())),
                             ms=cuda_ms(lambda: group_norm_sums_cuda(xh)),
                             plain_ms=cuda_ms(lambda: group_norm_sums_plain(xh)),
                             library_ms=None, bound_ms=sb, bound_by=sby))
            ab_, aby = bound(2 * nb + 2 * c * 4 + 2 * 32 * 4, 6 * xh.numel(), "float32_fma")
            rows.append(dict(common, kernel="groupnorm_apply", eps=eps, max_abs_err=err_a,
                             tol=TOL[("groupnorm", dt)],
                             ms=cuda_ms(lambda: group_norm_apply_cuda(xh, full, n, s, bias,
                                                                      eps=eps)),
                             plain_ms=cuda_ms(lambda: group_norm_apply_plain(
                                 xh, full, n, s, bias, eps=eps)),
                             library_ms=None, bound_ms=ab_, bound_by=aby))
            rows[-1]["fused_full_ms"] = cuda_ms(lambda: group_norm_cuda(x, s, bias, eps=eps))
    for r in rows:
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"[2 kernels] {r['model']:9s} {r['kernel']:15s} {r['dtype']:8s} "
            f"{str(r['shape']):25s} x{r['per_forward']}/fwd err {r['max_abs_err']:.2e} "
            f"(tol {r['tol']:.2e}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']}) share {r['bound_share']:.3f}"
            + (f"; fused entry at full height {r['fused_full_ms']:.4f} ms"
               if "fused_full_ms" in r else ""))
    log(f"[2 kernels] GroupNorm sums -> apply against the fused entry at "
        f"{len(set(gn_calls)) * 2} full-height shapes (one rank): "
        f"{'the same bits' if not not_equal else f'differ at {not_equal}'}")
    for dt in ("float32", "bfloat16"):
        mine = [r for r in rows if r["dtype"] == dt]
        tot = {k: sum(r[k] * r["per_forward"] for r in mine if k in r)
               for k in ("ms", "bound_ms", "fused_full_ms")}
        log(f"[2 kernels] P2 forward, {dt}, batch 1, rows split over two ranks: sums + "
            f"apply {tot['ms']:.4f} ms a rank (bound {tot['bound_ms']:.4f}) against the "
            f"fused entry at full height {tot['fused_full_ms']:.4f} ms")
    if not_equal:
        fail(f"GroupNorm sums -> apply differ from the fused entry: {not_equal}")
    bad = [r for r in rows if not r["max_abs_err"] <= r["tol"]]
    if bad:
        fail(f"GroupNorm split entries disagree with their plain versions: {bad}")
    return rows


def sp_kernel_rows(model):
    """Phase 2's rows for spatial parallelism over two ranks (batch 1, one
    P2 forward): the GroupNorm split entries at half height (sp_gn_rows) and
    attention with the local queries against every key, f32."""
    gn_calls, attn_calls = record_call_shapes(model, "P2")
    g = torch.Generator("cuda").manual_seed(1)
    rows = sp_gn_rows(gn_calls, g)
    sp_attn = [(h, nq // P15_WORLD, nkv, d) for h, nq, nkv, d in attn_calls]
    for shape in sorted(set(sp_attn)):
        r = attn_row("P2-SP2", torch.float32, 1, shape, sp_attn.count(shape), g)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"[2 kernels] {r['model']:9s} flash_attention float32 {str(r['shape']):25s} "
            f"{r['route']} x{r['per_forward']}/fwd err {r['max_abs_err']:.2e} (tol "
            f"{r['tol']:.2e}, mutants {r['mutant_errs']}) kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} library {r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
            f"share {r['bound_share']:.3f}")
        if not r["max_abs_err"] <= r["tol"] or not all(
                e > r["tol"] for e in r["mutant_errs"].values()):
            fail(f"attention at a spatially split shape: {r}")
        rows.append(r)
    return rows


def phase_mesh(work_dir, device="cuda", world=P15_WORLD):
    """15: phase 15's paths in `world` ranks (two on the one card over gloo;
    with --ranks N, one a card over NCCL where there are N cards), each held
    to the one-process run in this process. Returns the launches of each
    path summed over the ranks, and records the ranks' call shapes."""
    t0 = time.perf_counter()
    ranks = p15_spawn(work_dir, device, world)
    ranks_s = time.perf_counter() - t0
    for r, o in enumerate(ranks):
        log(f"[15 mesh] rank {r}: backend {o['backend']}, device {o['device']}, launches "
            f"{o['launches']}, seconds {({k: round(v, 2) for k, v in o['seconds'].items()})}, "
            f"peak {o['peak_gib']:.2f} GiB")
        for k, n in o["calls"].items():
            MAIN_PATH_CALLS[k] = MAIN_PATH_CALLS.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    one = p15_paths(False, work_dir, device, world)
    one_s = time.perf_counter() - t1
    fault = torch.from_numpy(one["strips_fault"])
    nums = {"strips_fault_rel_l2": float((fault - torch.from_numpy(one["strips"])).norm()
                                         / torch.from_numpy(one["strips"]).norm())}
    # the planted fault must miss the limit the ranks are held to
    checks = {"strips_fault_fails": nums["strips_fault_rel_l2"] > FWD_RTOL}
    for r, o in enumerate(ranks):
        tr = [max(rel_err(torch.tensor(m[k]), torch.tensor(w_[k])) for k in m)
              for m, w_ in zip(o["train_f32"]["metrics"], one["train_f32"]["metrics"])]
        ck = abs(o["train_f32"]["checksum"] - one["train_f32"]["checksum"]) / abs(
            one["train_f32"]["checksum"])
        nums[f"rank{r}_train_rel"] = max(tr + [ck])
        checks[f"rank{r}_train_f32"] = nums[f"rank{r}_train_rel"] <= P15_TRAIN_RTOL
        losses = o["train_bf16"]
        checks[f"rank{r}_bf16_loss_falls"] = bool(np.isfinite(losses).all()
                                                  and losses[-1] < losses[0])
        ov = []
        for g_ in range(2):
            cos = np.linalg.svd(o["basis"][g_] @ one["basis"][g_].T, compute_uv=False)
            ov.append((float((cos ** 2).mean()), float(cos.min())))
        nums[f"rank{r}_basis_overlap_mincos"] = ov
        checks[f"rank{r}_basis"] = min(v for v, _ in ov) >= P15_OVERLAP
        a, b_ = torch.from_numpy(o["strips"]), torch.from_numpy(one["strips"])
        nums[f"rank{r}_strips_rel_l2"] = float((a - b_).norm() / b_.norm())
        checks[f"rank{r}_strips"] = nums[f"rank{r}_strips_rel_l2"] <= FWD_RTOL
        for k in ("eps", "jv"):
            nums[f"rank{r}_sp_{k}_rel"] = rel_err(torch.from_numpy(o["sp"][k]),
                                                  torch.from_numpy(one["sp"][k]))
            checks[f"rank{r}_sp_{k}"] = nums[f"rank{r}_sp_{k}_rel"] <= FWD_RTOL
        la = o["launches"]
        checks[f"rank{r}_sp_uses_split_gn"] = (la["p15_sp"]["groupnorm"] == 0
                                               and la["p15_sp"]["groupnorm_sums"] > 0
                                               and la["p15_sp"]["groupnorm_apply"]
                                               == la["p15_sp"]["groupnorm_sums"]
                                               and la["p15_sp"]["flash_attention"] > 0)
        checks[f"rank{r}_others_use_kernels"] = all(
            la[p]["groupnorm"] > 0 and la[p]["flash_attention"] > 0
            for p in ("p15_train_f32", "p15_train_bf16", "p15_basis", "p15_strips"))
        checks[f"rank{r}_finite"] = bool(np.isfinite(o["strips"]).all()
                                         and np.isfinite(o["sp"]["jv"]).all())
    log(f"[15 mesh] FFHQ_P2 at full width in {world} ranks on "
        f"{min(world, torch.cuda.device_count())} card(s), backend {ranks[0]['backend']}: ranks "
        f"{ranks_s:.1f} s (spawn, build load and all paths), the one-process runs "
        f"{one_s:.1f} s ({({k: round(v, 2) for k, v in one['seconds'].items()})}); "
        f"f32 train {P15_TRAIN_STEPS} steps at {P15_BATCH // world} a rank (one "
        f"process {P15_BATCH}): loss/grad_norm/checksum tol {P15_TRAIN_RTOL:.0e}; bf16 "
        f"losses rank 0 {[round(v, 5) for v in ranks[0]['train_bf16']]}; basis rank "
        f"{P15_RANK}+{P15_RANK}, {P15_SWEEPS} sweeps (overlap tol {P15_OVERLAP}); strips "
        f"{P15_FRAMES} frames from edit_t {P15_STRIP_EDIT_T} (rel L2 tol {FWD_RTOL:.0e}, "
        f"f32; the planted fault must exceed it); SP f32 eps and J.v "
        f"(tol {FWD_RTOL:.0e}); numbers {nums}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 15 checks failed: {checks}")
    paths = {}
    for o in ranks:
        for path, la in o["launches"].items():
            for k, v in la.items():
                paths.setdefault(path, {}).setdefault(k, 0)
                paths[path][k] += v
    return paths


def summarize_split(rows, name, launches):
    """A kernels-line entry for a GroupNorm split entry: the sums over one
    P2 forward's calls with the rows over two ranks (f32, batch 1: the SP
    path's), per rank."""
    mine = [r for r in rows if r["kernel"] == name and r["dtype"] == "float32"]
    tot = {k: sum(r[k] * r["per_forward"] for r in mine) for k in ("ms", "plain_ms", "bound_ms")}
    by_bytes = sum(r["per_forward"] * r["bound_ms"] for r in mine if r["bound_by"] == "bytes")
    return {"name": name, "route": "cuda", "source": "loco_edit_tpu_torch/csrc/groupnorm.cu",
            "replaces": "loco_edit_tpu/ops/pallas/groupnorm_stats.py:79",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            **tot, "bound_by": "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations",
            "library_ms": None}


# full-width f32 outputs of the 3xTF32 convolution route against the same
# computation on the f32 engines alone (the route off), on the card,
# relative to the largest value: both are f32-accurate (the route's P2 eps
# reads ~9e-6 off the CPU, full f32 ~6e-6); one TF32 rounding of the
# operands lands ~9e-4 off (phase 3)
CONV_ROUTE_RTOL = 1e-4
# the split kernel's bytes a value: reads it (4), writes hi (4) and the pair (8)
CONV_SPLIT_BYTES = 16


def conv_route_calls(model, fn):
    """fn() with a forward pre-hook on each of model's ops.Conv2d modules;
    returns fn's result and the number of calls the route's rule admits
    (f32, MIN_CHANNELS in and out, wider than 1x1 or MIN_1X1_OUT outputs,
    MIN_FLOP operations as the caller sees the shapes)."""
    from loco_edit_tpu_torch.ops import conv

    routed = []

    def pre(mod, args):
        x = args[0]
        o, c, kh, kw = mod.weight.shape
        ho = (x.shape[2] + 2 * mod.padding[0] - kh) // mod.stride[0] + 1
        wo = (x.shape[3] + 2 * mod.padding[1] - kw) // mod.stride[1] + 1
        flop = 2.0 * x.shape[0] * ho * wo * o * c * kh * kw
        if (x.dtype == torch.float32 and min(o, c) >= conv.MIN_CHANNELS
                and (kh * kw > 1 or o >= conv.MIN_1X1_OUT) and flop >= conv.MIN_FLOP):
            routed.append(tuple(x.shape))

    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if isinstance(m, conv.Conv2d)]
    try:
        out = fn()
    finally:
        for h in hooks:
            h.remove()
    return out, len(routed)


def conv_route_path(name, model, fn, passes, seen):
    """One main path of the route: fn() with split_cuda.launches set to 0
    just before and read just after, held to the rule's routed calls times
    the path's passes (1 a forward; 2 a jvp or vjp: the primal, then the
    tangent or the input gradient); its output against the route off
    within CONV_ROUTE_RTOL. The activation shapes the kernel was handed
    (and whether channels_last) are added to `seen`."""
    from loco_edit_tpu_torch.ops import conv

    split = conv.split

    def recording(t, chunks=1):
        seen.add((tuple(t.shape), t.is_contiguous(memory_format=torch.channels_last), chunks))
        return split(t, chunks)

    conv.split = recording
    conv.split_cuda.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, routed = conv_route_calls(model, fn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        conv.split = split
    launches = conv.split_cuda.launches
    takes_route = conv.takes_route
    conv.takes_route = lambda *a: False
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = fn()
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    finally:
        conv.takes_route = takes_route
    err = rel_err(out, ref)
    log(f"[16 conv route] {name}: {secs:.3f} s (f32 engines alone {ref_s:.3f} s); split "
        f"launches {launches}, predicted {routed} routed calls x {passes} = "
        f"{routed * passes}; against the route off {err:.3g} (tolerance {CONV_ROUTE_RTOL})")
    if launches != routed * passes:
        fail(f"conv route {name}: split launches {launches} != predicted {routed * passes}")
    if err > CONV_ROUTE_RTOL:
        fail(f"conv route {name}: {err:.3g} off the f32 engines, over {CONV_ROUTE_RTOL}")
    return launches


def conv_split_rows(seen):
    """csrc/conv_split.cu against split_plain, bit for bit, at each shape
    and number of chunks the main paths handed it (seeded data, the same
    layout), timed beside the plain version and its bytes bound
    (CONV_SPLIT_BYTES a value)."""
    from loco_edit_tpu_torch.ops import conv

    rows = []
    g = torch.Generator("cuda").manual_seed(16)
    for shape, channels_last, chunks in sorted(seen):
        t = torch.randn(shape, device="cuda", generator=g) * 3.0
        if channels_last:
            t = t.contiguous(memory_format=torch.channels_last)
        his, pair = conv.split_cuda(t, chunks)
        hi, want_pair = conv.split_plain(t.contiguous(memory_format=torch.channels_last))
        same = (torch.equal(pair, want_pair) and all(
            a.shape == b.shape and torch.equal(a, b) and
            a.is_contiguous(memory_format=torch.channels_last)
            for a, b in zip(his, hi.chunk(chunks, dim=1))))
        del his, pair, hi, want_pair
        ms = cuda_ms(lambda: conv.split_cuda(t, chunks))
        plain_ms = cuda_ms(lambda: conv.split_plain(t))
        bound_ms, by = bound(CONV_SPLIT_BYTES * t.numel(), 0.0, "float32")
        rows.append({"kernel": "conv_split", "dtype": "float32", "shape": list(shape),
                     "channels_last": channels_last, "chunks": chunks, "bitwise": same,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                     "share": bound_ms / ms})
        log(f"[16 conv route] split {tuple(shape)} {'NHWC' if channels_last else 'NCHW'} "
            f"in {chunks}: {'the same bits' if same else 'DIFFERENT bits'}; kernel {ms:.3f} "
            f"ms, plain {plain_ms:.3f} ms, bytes bound {bound_ms:.3f} ms "
            f"({100 * bound_ms / ms:.0f} %)")
        del t
        torch.cuda.empty_cache()
    bad = [r["shape"] for r in rows if not r["bitwise"]]
    if bad:
        fail(f"conv_split differs from split_plain at {bad}")
    return rows


def phase_conv_route():
    """Phase 16: the 3xTF32 convolution route (ops/conv.py) on the cells'
    main paths at full width, f32: FFHQ_P2 (a strip forward at batch 9, a
    J.v over 5 probes and a J^T.u over 3 at batch 1), the LCM VAE decoder
    at 512 px (a decode, a J.v over 10 probes, a J^T.u over 5) and IF-II-L
    (a forward at batch 6, 256 px, the upscale's CFG batch); each path's
    split launches against the rule's prediction and its output against
    the route off; then the split kernel at every shape they gave it."""
    from loco_edit_tpu_torch.core.device import use_full_f32
    from loco_edit_tpu_torch.models.ifm import IFUNet, if_preset
    from loco_edit_tpu_torch.models.registry import load_adm_denoiser

    use_full_f32(torch.float32)
    func = torch.func
    seen, launches = set(), {}
    g = torch.Generator().manual_seed(16)

    def jvp_path(f, x, probes):
        return lambda: func.vmap(lambda v: func.jvp(f, (x,), (v,))[1])(probes)

    def vjp_path(f, x, n):
        def run():
            y, pull = func.vjp(f, x)
            cot = torch.randn(n, *y.shape, device="cuda",
                              generator=torch.Generator("cuda").manual_seed(n))
            return func.vmap(pull)(cot)[0]
        return run

    den = load_adm_denoiser("FFHQ_P2", dtype=torch.float32, device="cuda", seed=0)
    p2 = den.meta["model"].requires_grad_(False).eval()
    x1 = torch.randn(1, 256, 256, 3, generator=g).cuda()

    def eps(z):
        return p2(z, 595.0)

    x9 = torch.randn(9, 256, 256, 3, generator=g).cuda()
    with torch.no_grad():
        launches["p2_strip_b9"] = conv_route_path("p2 strip b9", p2, lambda: eps(x9), 1, seen)
    launches["p2_jvp_5"] = conv_route_path(
        "p2 jvp 5", p2, jvp_path(eps, x1, torch.randn(5, *x1.shape, generator=g).cuda()), 2,
        seen)
    launches["p2_vjp_3"] = conv_route_path("p2 vjp 3", p2, vjp_path(eps, x1, 3), 2, seen)
    del den, p2
    torch.cuda.empty_cache()

    dec = load_lcm_models("fp32")["decoder"].requires_grad_(False).eval()
    z = torch.randn(1, 64, 64, 4, generator=g).cuda()
    with torch.no_grad():
        launches["lcm_decode"] = conv_route_path("lcm decode", dec, lambda: dec(z), 1, seen)
    launches["lcm_decode_jvp_10"] = conv_route_path(
        "lcm decode jvp 10", dec, jvp_path(dec, z, torch.randn(10, *z.shape, generator=g).cuda()),
        2, seen)
    launches["lcm_decode_vjp_5"] = conv_route_path("lcm decode vjp 5", dec,
                                                   vjp_path(dec, z, 5), 2, seen)
    del dec
    gc.collect()
    torch.cuda.empty_cache()

    cfg = if_preset("IF-II-L", dtype=torch.float32)
    with torch.device("cuda"):
        m2 = IFUNet(cfg)
    m2.init_random_(torch.Generator("cuda").manual_seed(3))
    m2.requires_grad_(False).eval()
    x6 = torch.randn(6, cfg.sample_size, cfg.sample_size, cfg.in_channels, generator=g).cuda()
    ctx = torch.randn(6, 77, cfg.encoder_hid_dim, generator=g).cuda()
    with torch.no_grad():
        launches["if_ii_l_b6"] = conv_route_path(
            "IF-II-L b6", m2, lambda: m2(x6, 500.0, ctx, 250.0), 1, seen)
    del m2
    gc.collect()
    torch.cuda.empty_cache()
    return conv_split_rows(seen), launches


def summarize_conv_split(rows, launches):
    """The kernels-line entry of the split kernel: its rows (one a shape the
    main paths gave it) and its launches by path."""
    return {"name": "conv_split", "route": "cuda",
            "source": "loco_edit_tpu_torch/csrc/conv_split.cu", "replaces": None,
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": 0.0, "rows": rows}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=0,
                    help="run phases 1 and 15 alone over this many ranks")
    ap.add_argument("--conv_route", action="store_true",
                    help="run phases 1 and 16 alone")
    args = ap.parse_args(argv)
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
    from loco_edit_tpu_torch.models.ddpm import load_ddpm_denoiser
    from loco_edit_tpu_torch.models.registry import load_adm_denoiser

    t_start = time.perf_counter()
    smi = phase_build()
    if args.ranks:
        with tempfile.TemporaryDirectory() as work_dir:
            phase_mesh(work_dir, world=args.ranks)
        log(f"[15 mesh] phase: {time.perf_counter() - t_start:.1f} s with the build")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.conv_route:
        split_rows, split_launches = phase_conv_route()
        log(f"[16 conv route] phase: {time.perf_counter() - t_start:.1f} s with the build")
        print(smi)
        print(json.dumps({"kernels": [summarize_conv_split(split_rows, split_launches)]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    den32 = load_adm_denoiser("FFHQ_P2", dtype=torch.float32, device="cuda", seed=0)
    with tf32_convs(False):
        rows = phase_kernels(den32.meta["model"], "P2")
        rows += sp_kernel_rows(den32.meta["model"])
        phase_forward_vs_cpu(den32, "FFHQ_P2")
    del den32
    ddpm32 = load_ddpm_denoiser("CelebA_HQ_HF", dtype=torch.float32, device="cuda", seed=0)
    with tf32_convs(False):
        rows += phase_kernels(ddpm32.meta["model"], "DDPM")
        phase_forward_vs_cpu(ddpm32, "CelebA_HQ_HF")
    del ddpm32
    sd32 = load_sd_models("fp32")
    with tf32_convs(False):
        for tag, calls in record_sd_call_shapes(sd32).items():
            rows += kernel_rows(tag, *calls)
        phase_sd_forward_vs_cpu(sd32)
    del sd32
    torch.cuda.empty_cache()

    den16 = load_adm_denoiser("FFHQ_P2", dtype=torch.bfloat16, device="cuda", seed=0)
    with tempfile.TemporaryDirectory() as work_dir:
        p2_launches = phase_flagship(den16, work_dir)
    del den16
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        edit_launches, group_launches = phase_ddpm_cli(work_dir)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        sd_edit, sd_delta, sd_invert = phase_sd_cli(work_dir)
    torch.cuda.empty_cache()

    lcm32 = load_lcm_models("fp32")
    n_lcm = sum(p.numel() for p in lcm32["unet"].parameters())
    log(f"[9 lcm] LCM Dreamshaper v7 U-Net: {n_lcm:,} parameters (expected "
        f"{LCM_UNET_PARAMS:,}: SD 1.5's and cond_proj's)")
    if n_lcm != LCM_UNET_PARAMS:
        fail(f"LCM U-Net has {n_lcm} parameters, expected {LCM_UNET_PARAMS}")
    with tf32_convs(False):
        rows += phase_lcm_kernels_and_forward(lcm32)
    del lcm32
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        lcm_edit, lcm_delta = phase_lcm_cli(work_dir)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lcm_f32 = phase_lcm_f32_cli(work_dir)
        log(f"[9 lcm f32] phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work_dir:
        ckpts = [os.path.join(work_dir, f"if_stage{i}.pt") for i in (1, 2)]
        t0 = time.perf_counter()
        counts = [write_if_checkpoint(name, path, seed) for name, path, seed in
                  (("IF-I-M", ckpts[0], 10), ("IF-II-M", ckpts[1], 11))]
        log(f"[10 if] wrote seeded diffusers-named IF-I-M ({counts[0]:,} parameters; the "
            f"JAX build's {IF_I_M_PARAMS:,}) and IF-II-M ({counts[1]:,}) checkpoints in "
            f"{time.perf_counter() - t0:.1f} s")
        if counts != [IF_I_M_PARAMS, IF_II_M_PARAMS]:
            fail(f"IF parameter counts {counts} != {[IF_I_M_PARAMS, IF_II_M_PARAMS]}")
        with tf32_convs(False):
            rows += phase_if_kernels_and_forward(*ckpts)
        torch.cuda.empty_cache()
        if_edit = phase_if_cli(work_dir, *ckpts)
        torch.cuda.empty_cache()
        phase_verify_all(work_dir)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_sam()
    log(f"[11 sam] phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work_dir:
        p2_sam_edit = phase_p2_sam_cli(work_dir)
    log(f"[12 p2 sam] phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work_dir:
        serve_p2 = phase_serve_p2(work_dir)
        gc.collect()
        torch.cuda.empty_cache()
        serve_lcm = phase_serve_lcm(work_dir)
    log(f"[13 serve] phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work_dir:
        toolkit = phase_train_and_toolkit(work_dir)
    log(f"[14 train] phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work_dir:
        mesh_paths = phase_mesh(work_dir)
    log(f"[15 mesh] phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    split_rows, split_launches = phase_conv_route()
    log(f"[16 conv route] phase: {time.perf_counter() - t0:.1f} s")

    paths = {"p2_flagship": p2_launches, "ddpm_cli_edit": edit_launches,
             "ddpm_cli_group_edit": group_launches, "sd_cli_edit": sd_edit,
             "sd_delta_zt_via_grad": sd_delta, "sd_invert": sd_invert,
             "lcm_cli_edit": lcm_edit, "lcm_delta_zt_via_grad": lcm_delta,
             "lcm_f32_cli_edit": lcm_f32,
             "if_cli_edit": if_edit, "p2_f32_sam_cli_edit": p2_sam_edit,
             "serve_p2": serve_p2, "serve_lcm": serve_lcm, **toolkit,
             **{k: {n: v[n] for n in ("groupnorm", "flash_attention")}
                for k, v in mesh_paths.items()}}
    check_main_path_calls(rows)
    kernels = [
        summarize(rows, "groupnorm", "loco_edit_tpu_torch/csrc/groupnorm.cu",
                  "loco_edit_tpu/ops/pallas/groupnorm_stats.py:79",
                  {k: v["groupnorm"] for k, v in paths.items()}),
        summarize(rows, "flash_attention", "loco_edit_tpu_torch/csrc/flash_attention.cu",
                  "loco_edit_tpu/ops/pallas/flash_attention.py:67",
                  {k: v["flash_attention"] for k, v in paths.items()}),
        summarize_split(rows, "groupnorm_sums",
                        {k: v["groupnorm_sums"] for k, v in mesh_paths.items()}),
        summarize_split(rows, "groupnorm_apply",
                        {k: v["groupnorm_apply"] for k, v in mesh_paths.items()}),
        summarize_conv_split(split_rows, split_launches),
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

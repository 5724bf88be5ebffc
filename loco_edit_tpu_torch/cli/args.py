"""CLI flag surface (port of loco_edit_tpu/cli/args.py): the JAX package's
flags, the same `preset()` derivation (family booleans, run folders with
script archiving, per-family input sizes, the x-space-guidance scale lookup,
the scheduler invariants), plus `--device`, the port's counterpart of
JAX_PLATFORMS: the card ("cuda", the default) or "cpu".

The port runs the unconditional engines and the SD, LCM and DeepFloyd-IF
engines, with SAM masks (the two-phase --sampling_mode / --mask_index
protocol), `--verify_load`, `--trace_dir` and `--pixel_output`.
`check_supported` raises NotImplementedError, naming the ROADMAP.md item
that ports it, for every flag set to a value this port cannot honour yet
(the mesh flags); no flag is silently ignored.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

# reference src/configs/params.py:1-22 — x-space-guidance scale by family x h_t
X_SPACE_GUIDANCE_SCALE = {
    "stable-diffusion": {1.0: 0.5, 0.9: 0.5, 0.8: 1, 0.7: 1, 0.6: 2, 0.5: 2,
                         0.4: 2, 0.3: 2, 0.2: 2, 0.1: 2, 0.0: 0},
    "uncond": {1.0: 0.5, 0.8: 1, 0.6: 4, 0.4: 16, 0.2: 16},
}


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() == "true":
        return True
    if v.lower() == "false":
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def parse_args(argv=None):
    p = argparse.ArgumentParser("loco-edit-tpu")
    add = p.add_argument

    # default setting
    add("--sh_file_name", type=str, default="")
    add("--dtype", type=str, default="fp32", help="fp32 | bf16 (compute dtype)")
    add("--seed", type=int, default=0)
    add("--device", type=str, default="cuda",
        help="cuda (the card, the default) | cpu (the plain PyTorch versions)")
    add("--result_folder", type=str, default="./runs/")
    add("--cache_folder", type=str, default="./cache/")
    add("--dataset_root", type=str, default="")

    # model, dataset
    add("--model_name", type=str, default="")
    add("--dataset_name", type=str, default="")
    add("--checkpoint_path", type=str, default="",
        help="local torch .pt (converted on load) or .npz of Flax params")
    add("--stage2_checkpoint_path", type=str, default="",
        help="IF-II upscaler checkpoint (diffusers .pt/.bin); enables stage 2")
    add("--vae_path", type=str, default="",
        help="local VAE checkpoint (SD/LCM engines)")
    add("--text_encoder_path", type=str, default="",
        help="local transformers dir for CLIP (SD/LCM) or T5 (IF)")
    add("--image_size", type=int, default=256)
    add("--c_in", type=int, default=3)
    add("--sample_idx", type=int, default=0)

    # prompts (T2I engines)
    add("--for_prompt", type=str, default="")
    add("--inv_prompt", type=str, default="")
    add("--edit_prompt", type=str, default="")

    # diffusion schedule
    add("--for_steps", type=int, default=100)
    add("--inv_steps", type=int, default=100)
    # >0: per-step fixed-point refinement toward the exact DDIM inverse
    # (AIDI/ReNoise-family technique; 0 = the reference's explicit
    # approximation). Costs inv_refine_steps extra eps evals per step.
    add("--inv_refine_steps", type=int, default=0)
    add("--performance_boosting_t", type=float, default=0.0)
    add("--use_yh_custom_scheduler", type=str2bool, default=True)
    add("--noise_schedule", type=str, default="linear")

    # guidance
    add("--guidance_scale", type=float, default=0.0)
    add("--guidance_scale_edit", type=float, default=4.0)
    # IF stage-2 CFG: the diffusers IFSuperResolutionPipeline default (4.0),
    # deliberately NOT inherited from the stage-1 --guidance_scale (the
    # reference upscales with the pipeline default, edit.py:1375-1392)
    add("--stage2_guidance_scale", type=float, default=4.0)

    # x-space guidance / subspace ranks
    add("--use_x_space_guidance", type=str2bool, default=False)
    add("--x_space_guidance_edit_step", type=float, default=1.0)
    add("--x_space_guidance_scale", type=float, default=0.0)
    add("--x_space_guidance_num_step", type=int, default=0)
    add("--pca_rank", type=int, default=5)
    add("--pca_rank_null", type=int, default=5)
    add("--h_t", type=float, default=0.8)
    add("--edit_t", type=float, default=1.0)

    # memory / execution
    add("--memory_bound", type=int, default=0, help="0 = no batch chunking")
    add("--pixel_output", type=str2bool, default=False,
        help="convert edited strips to uint8 pixels ON DEVICE before the "
             "host pull (4x smaller transfer; the strips are the PNG "
             "payload either way)")
    add("--probe_chunk", type=int, default=0, help="0 = all probes batched")
    add("--mesh_probe", type=int, default=0,
        help="split the probes over this many ranks (torchrun; 0 = one process)")
    add("--mesh_data", type=int, default=0,
        help="split the walk-strip / batch-edit frame axis over this "
             "many ranks (torchrun; 0 = one process)")
    add("--mesh_sp", type=int, default=0,
        help="split the image height over this many ranks (spatial "
             "parallelism for batch-1 inversion/pullback, uncond engine; "
             "0 = off)")

    # experiments
    add("--run_ddim_forward", type=str2bool, default=False)
    add("--run_ddim_inversion", type=str2bool, default=False)
    add("--run_edit_null_space_projection", type=str2bool, default=False)
    add("--run_edit_null_space_projection_zt", type=str2bool, default=False)
    add("--run_edit_null_space_projection_zt_semantic", type=str2bool, default=False)
    add("--run_edit_null_space_projection_xt", type=str2bool, default=False)
    add("--run_edit_null_space_projection_xt_semantic", type=str2bool, default=False)
    add("--group_edit_null_space_projection", type=str2bool, default=False)
    add("--encoder_decoder_by_et", type=str2bool, default=False)
    add("--use_mask", type=str2bool, default=True)
    add("--null_space_projection", type=str2bool, default=False)
    add("--vis_num", type=int, default=4)
    add("--choose_sem", type=str, default="hair")
    add("--random_edit", type=str2bool, default=False)
    add("--non_semantic", type=str2bool, default=False)
    add("--jacobian", type=str2bool, default=False)
    add("--note", type=str, default="")

    # modes
    add("--verify_load", type=str, default="",
        help="verify a real checkpoint end to end (convert + strict key "
             "coverage + forward + torch oracle where available) and exit; "
             "one of: adm, ddpm, sd_unet, sd_vae, ifm, lpips, sam — or "
             "'all' to sweep every checkpoint under --checkpoint_path "
             "(classified by key fingerprint, ADM/DDPM presets fitted to "
             "each file's geometry) into one JSON report. The "
             "first command to run on a machine with real weights "
             "(docs/MIGRATION.md)")
    add("--sampling_mode", type=str2bool, default=False)
    # a torch.profiler trace of the whole run, <trace_dir>/trace.json
    add("--trace_dir", type=str, default="")

    # mask segmentation
    add("--mask_model_name", type=str, default="facebook/sam-vit-large",
        help="a local SamModel.save_pretrained dir, a file holding a HF-named "
             "SamModel state_dict, or a hub name (seeded random weights at its "
             "geometry: masks/sam.py::prepare_sam)")
    # flax: the port's own SAM on --device (the value keeps the JAX name);
    # hf_pipeline: transformers' pipeline on the host
    add("--mask_backend", type=str, default="hf_pipeline",
        choices=["hf_pipeline", "flax"])
    add("--filter_mask", type=int, default=100)
    add("--mask_index", type=int, default=0)
    add("--mask_type", type=str, default="SAM", choices=["SAM", "diffedit"])
    add("--ablation_method", type=str, default=None,
        choices=["null-space-proj", "sega", "diffedit"])
    add("--tilda_v_score_type", type=str, default=None,
        choices=["proj_null[for-null](edit-null)-direct", "(for-edit)-direct",
                 "(edit-null)-direct", "null+(for-null)+(edit-null)",
                 "null+(for-null)", "null+(edit-null)", "(for-edit)",
                 "edit-proj[for](edit)", "null+for+edit-proj[for](edit)"])
    add("--vT_path", type=str, default="")
    add("--vT1_path", type=str, default="")
    add("--use_sega", type=str2bool, default=False)
    add("--edit_t_idx", type=int, default=1)
    add("--num_inference_steps", type=int, default=3)

    return p.parse_args(argv)


# flag -> (its default, the ROADMAP.md item that ports what it selects):
# empty since every flag of the JAX CLI is ported
UNPORTED: dict[str, tuple] = {}


def check_supported(args) -> None:
    """Raise NotImplementedError for a flag set to a value the port cannot
    honour yet (none remain), and ValueError for --mesh_sp on a T2I engine:
    spatial parallelism applies to the uncond engine, as in the JAX CLI,
    which ignores the flag there."""
    for flag, (default, item) in UNPORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)!r}: not ported yet, see ROADMAP.md {item}")
    name = args.model_name
    if args.mesh_sp > 1 and ("stable-diffusion" in name or "DeepFloyd" in name
                             or "LCM" in name):
        raise ValueError(f"--mesh_sp {args.mesh_sp}: spatial parallelism runs the "
                         f"uncond engine only, not {name!r}")


def preset(args):
    """Derive run configuration (reference preset(), define_argparser.py:138)."""
    if args.seed == 0:
        import random as _r

        args.seed = _r.randint(1, 2**31 - 1)

    name = args.model_name
    args.is_stable_diffusion = "stable-diffusion" in name
    args.is_DeepFloyd_IF_diffusion = "DeepFloyd" in name
    args.is_LCM = "LCM" in name

    if args.is_stable_diffusion:
        args.exp = f"Stable_Diffusion-{args.dataset_name}-{args.note}"
    elif args.is_DeepFloyd_IF_diffusion:
        args.exp = f"DeepFloyd-IF-{args.dataset_name}-{args.note}"
    elif args.is_LCM:
        args.exp = f"LCM-{args.dataset_name}-{args.note}"
    else:
        known = ("FFHQ_P2", "AFHQ_P2", "Flower_P2", "Cub_P2", "Metface_P2",
                 "CelebA_HQ_HF", "LSUN_church_HF", "LSUN_bedroom_HF", "FFHQ_HF",
                 "LSUN_bedroom", "LSUN_cat", "LSUN_horse",
                 "ImageNet256Uncond", "ImageNet256Cond", "ImageNet128Cond",
                 "ImageNet64Cond", "CIFAR10Uncond", "CelebA_HQ", "TinyTest")
        if name not in known:
            raise ValueError(f"model_name {name!r} not in {known}")
        args.exp = f"{name}-{args.dataset_name}"

    args.exp_folder = os.path.join(args.result_folder, args.exp)
    os.makedirs(args.exp_folder, exist_ok=True)
    # run-dir self-archiving (reference define_argparser.py:192-194)
    for src in (args.sh_file_name, __file__, sys.argv[0]):
        if src and os.path.isfile(src):
            try:
                shutil.copy(src, os.path.join(args.exp_folder, os.path.basename(src)))
            except shutil.SameFileError:
                pass
    args.obs_folder = os.path.join(args.exp_folder, "obs")
    args.result_folder = os.path.join(args.exp_folder, "results")
    os.makedirs(args.obs_folder, exist_ok=True)
    os.makedirs(args.result_folder, exist_ok=True)

    # x-space-guidance scale lookup by h_t (define_argparser.py:210-214)
    if args.use_x_space_guidance and args.x_space_guidance_scale == 0.0:
        fam = "stable-diffusion" if args.is_stable_diffusion else "uncond"
        args.x_space_guidance_scale = X_SPACE_GUIDANCE_SCALE[fam][args.h_t]

    # per-family input geometry (define_argparser.py:216-236)
    if name == "TinyTest":
        args.c_in, args.image_size, args.memory_bound = 3, 32, args.memory_bound or 50
        return args  # smoke preset: skip production invariants
    if args.is_stable_diffusion:
        args.c_in, args.image_size, args.memory_bound = 4, 64, args.memory_bound or 5
    elif "CIFAR10" in name:
        args.c_in, args.image_size, args.memory_bound = 3, 32, args.memory_bound or 50
    elif args.is_DeepFloyd_IF_diffusion:
        args.c_in, args.image_size, args.memory_bound = 3, 64, args.memory_bound or 5
    else:
        args.c_in, args.image_size, args.memory_bound = 3, 256, args.memory_bound or 50
        args.noise_schedule = "linear"

    # scheduler invariants (define_argparser.py:238-247)
    if args.is_stable_diffusion or args.is_DeepFloyd_IF_diffusion:
        assert args.use_yh_custom_scheduler
        assert args.performance_boosting_t <= 0
    elif not args.is_LCM:
        assert args.use_yh_custom_scheduler
        assert args.for_steps == 100
        assert args.performance_boosting_t == 0.2

    return args

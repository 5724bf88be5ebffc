"""CLI entry point (port of loco_edit_tpu/cli/main.py): parse flags,
preset, build the engine for the model family (the uncond ADM and DDPM
families, SD, LCM, DeepFloyd-IF), dispatch experiments. Runs on the card
unless `--device cpu`.

Run e.g.:
  python -m loco_edit_tpu_torch.cli.main --model_name CelebA_HQ_HF \
      --dataset_name CelebA_HQ_mask --dataset_root /data/CelebAMask-HQ \
      --checkpoint_path ddpm-ema-celebahq-256.bin --choose_sem hair \
      --run_edit_null_space_projection true --null_space_projection true \
      --edit_t 0.6 --performance_boosting_t 0.2 --use_x_space_guidance true \
      --x_space_guidance_num_step 16 --h_t 0.6

or, for Stable Diffusion 2.1-base (SAM masks of the generated image are
cached at result_folder/mask/mask.npz on the first run; --mask_index picks
one):
  python -m loco_edit_tpu_torch.cli.main \
      --model_name stabilityai/stable-diffusion-2-1-base --dtype bf16 \
      --checkpoint_path unet.bin --vae_path vae.bin --text_encoder_path clip/ \
      --for_prompt "a photo of a cat" --guidance_scale 7.5 --edit_t 0.7 \
      --performance_boosting_t 0 --use_x_space_guidance true --h_t 0.7 \
      --x_space_guidance_num_step 8 --run_edit_null_space_projection_zt true \
      --null_space_projection true
"""

from __future__ import annotations

import os
import sys

import numpy as np


def build_uncond_pipeline(args):
    from loco_edit_tpu_torch.core.rng import seed_everything
    from loco_edit_tpu_torch.diffusion import LinspaceDDIM
    from loco_edit_tpu_torch.models.registry import load_denoiser
    from loco_edit_tpu_torch.pipelines import UncondEditConfig, UncondEditPipeline

    rng = seed_everything(args.seed)
    denoiser = load_denoiser(args)
    if args.mesh_sp > 1:
        import dataclasses

        from loco_edit_tpu_torch.parallel.sp import make_sp_mesh, sp_denoiser

        denoiser = dataclasses.replace(
            denoiser, eps_fn=sp_denoiser(denoiser.eps_fn, make_sp_mesh(args.mesh_sp)))
    cfg = UncondEditConfig(
        for_steps=args.for_steps,
        inv_steps=args.inv_steps,
        inv_refine_steps=args.inv_refine_steps,
        edit_t=args.edit_t,
        performance_boosting_t=args.performance_boosting_t,
        x_space_guidance_scale=args.x_space_guidance_scale,
        x_space_guidance_edit_step=args.x_space_guidance_edit_step,
        x_space_guidance_num_step=args.x_space_guidance_num_step,
        vis_num=args.vis_num,
        vis_num_pc=args.pca_rank,
        pca_rank=args.pca_rank,
        pca_rank_null=args.pca_rank_null,
        null_space_projection=args.null_space_projection,
        encoder_decoder_by_et=args.encoder_decoder_by_et,
        probe_chunk=args.probe_chunk or None,
        mesh_probe=args.mesh_probe,
        mesh_data=args.mesh_data,
        memory_bound=args.memory_bound,
        pixel_output=args.pixel_output,
        result_folder=args.result_folder,
    )
    scheduler = LinspaceDDIM(noise_schedule=args.noise_schedule)
    pipe = UncondEditPipeline(denoiser, cfg, rng, scheduler, device=args.device)
    return pipe, denoiser, rng


def get_sample_and_mask(args, pipe, denoiser, rng):
    """Resolve the input image (dataset sample or seeded noise) and the edit
    mask (CelebAMask-HQ ground truth, the SAM cache, or none), mirroring the
    reference's branches (src/modules/edit.py:2234-2267). Returns (x0, xT,
    mask): numpy x0 or a latent xT on the pipeline's device, and a boolean
    NHWC mask or None."""
    from loco_edit_tpu_torch.data import get_dataset

    h, w, c = denoiser.sample_shape
    if args.dataset_name == "Random":
        xT = rng.fork("xT").normal((1, h, w, c), device=pipe.device)
        # SAM needs a decoded image: denoise xT to x0 lazily (only when the
        # mask cache is cold)
        mask = _sam_mask(args, None, make_image=lambda: pipe.generate(xT, 0, None)
                         .cpu().numpy()) if args.use_mask else None
        return None, xT, mask
    dataset = get_dataset(args.dataset_name, args.dataset_root, args.image_size,
                          save_path=os.path.join(args.result_folder, "dataset"))
    x0 = np.asarray(dataset[args.sample_idx])
    if args.dataset_name == "CelebA_HQ_mask":
        mask = dataset.getmask(args.sample_idx, args.choose_sem) if args.use_mask else None
    else:
        mask = _sam_mask(args, x0) if args.use_mask else None
    return x0, None, mask


def _read_mask(mask_path: str, mask_index: int) -> np.ndarray:
    with np.load(mask_path) as z:
        return z["masks"][mask_index][None].astype(bool)


def _sam_mask(args, x0, make_image=None):
    """SAM two-phase protocol: --sampling_mode extracts and caches the masks
    at result_folder/sample_idx{i}/mask/mask.npz, then exits 0; the
    follow-up run selects --mask_index (reference
    src/modules/mask_segmentation.py + edit.py:2237-2247). make_image
    supplies a generated sample lazily when x0 is None (the Random
    dataset)."""
    mask_path = os.path.join(args.result_folder, f"sample_idx{args.sample_idx}",
                             "mask", "mask.npz")
    if os.path.exists(mask_path):
        return _read_mask(mask_path, args.mask_index)
    if args.sampling_mode:
        from loco_edit_tpu_torch.masks.sam import check_sam_source, extract_and_cache_masks

        check_sam_source(args.mask_backend, args.mask_model_name)
        extract_and_cache_masks(args, make_image() if x0 is None else x0, mask_path)
        print("sampling_mode: masks extracted; rerun with --mask_index")
        sys.exit(0)
    raise FileNotFoundError(
        f"no cached mask at {mask_path}; run once with --sampling_mode true")


def _save_grid(images, path: str) -> None:
    """Write an image grid; with more than one rank, rank 0 writes."""
    from loco_edit_tpu_torch.core.mesh import is_main_process
    from loco_edit_tpu_torch.utils.io import save_image_grid

    if is_main_process():
        save_image_grid(images, path)


def start_ranks(args, device) -> None:
    """Under torchrun, start the process group (core/mesh.py); then check
    that each mesh flag fits the world, raising make_mesh's ValueError
    before any model is built, as the JAX CLI does with too few devices."""
    from loco_edit_tpu_torch.core.mesh import (initialize_distributed,
                                               resolve_axis_sizes, world_size)

    initialize_distributed(device=device)
    if args.mesh_sp > 1 and (args.mesh_probe > 1 or args.mesh_data > 1):
        raise ValueError("--mesh_sp splits every model call over the ranks; it "
                         "does not combine with --mesh_probe or --mesh_data")
    for flag in ("mesh_probe", "mesh_data", "mesh_sp"):
        n = getattr(args, flag)
        if n > 1:
            resolve_axis_sizes({flag[5:]: n}, world_size())


def main(argv=None):
    """Parse, check, preset and dispatch. Returns main_dispatch's results,
    or with --verify_load the verifier's report. With --trace_dir the whole
    run is traced (utils/logger.py::device_trace: CPU activity, plus the
    card's when the run is on it) into <trace_dir>/trace.json."""
    from loco_edit_tpu_torch.cli.args import check_supported, parse_args, preset
    from loco_edit_tpu_torch.core.cache import enable_compile_cache
    from loco_edit_tpu_torch.core.device import resolve_device

    args = parse_args(argv)
    check_supported(args)
    device = resolve_device(args.device)   # no card and no --device cpu: raise now
    print(f"kernel build directory: {enable_compile_cache()}", flush=True)
    start_ranks(args, device)
    if args.verify_load:
        from loco_edit_tpu_torch.cli.verify_load import verify_checkpoint

        return verify_checkpoint(args)
    args = preset(args)
    if args.trace_dir:
        from loco_edit_tpu_torch.utils.logger import device_trace

        trace_dir, args.trace_dir = args.trace_dir, ""
        with device_trace(trace_dir, cuda=device.type == "cuda"):
            return main_dispatch(args)
    return main_dispatch(args)


def main_dispatch(args) -> dict:
    """Run the experiments the flags select. Returns their outputs by name:
    "forward" and "inversion" (numpy batches), "edit" (the result dict of
    run_edit_null_space_projection, of run_edit_null_space_projection_zt for
    SD and LCM, of run_edit_null_space_projection_xt for IF), "group" (the
    group-edit frames), "mask" (IF's DiffEdit mask), and "timings" (seconds
    per pipeline phase of "edit" and "group")."""
    if args.is_LCM:
        return _main_lcm(args)
    if args.is_stable_diffusion:
        return _main_sd(args)
    if args.is_DeepFloyd_IF_diffusion:
        return _main_if(args)
    pipe, denoiser, rng = build_uncond_pipeline(args)
    results = {"timings": {}}

    if args.run_ddim_forward:
        h, w, c = denoiser.sample_shape
        xT = rng.fork("fwd").normal((5, h, w, c), device=pipe.device)
        x0 = pipe.generate(xT, 0, None).cpu().numpy()
        _save_grid(x0, os.path.join(args.result_folder, "DDIMforward.png"))
        results["forward"] = x0

    if args.run_ddim_inversion:
        x0, _, _ = get_sample_and_mask(args, pipe, denoiser, rng)
        if x0 is None:
            raise SystemExit("--run_ddim_inversion needs a real image; "
                             "--dataset_name Random has none")
        xT = pipe.invert(x0).cpu().numpy()
        _save_grid(xT, os.path.join(args.result_folder, "DDIMinversion.png"))
        results["inversion"] = xT

    if args.run_edit_null_space_projection:
        x0, xT, mask = get_sample_and_mask(args, pipe, denoiser, rng)
        results["edit"] = pipe.run_edit_null_space_projection(
            x0=x0, xT=xT, mask=mask,
            sample_name=f"sample_idx{args.sample_idx}",
            vT_path=args.vT_path or None, random_edit=args.random_edit)
        results["timings"]["edit"] = dict(pipe.timings)

    if args.group_edit_null_space_projection:
        x0, xT, mask = get_sample_and_mask(args, pipe, denoiser, rng)
        if xT is None:
            xT = pipe.invert(x0)
        results["group"] = pipe.group_edit(
            xT, [args.vT_path, args.vT1_path],
            sample_name=f"sample_idx{args.sample_idx}")
        results["timings"]["group"] = dict(pipe.timings)
    return results


def build_sd_pipeline(args):
    from loco_edit_tpu_torch.core.rng import seed_everything
    from loco_edit_tpu_torch.models.t2i_registry import load_sd_bundle
    from loco_edit_tpu_torch.pipelines.sd import SDEditConfig, SDEditPipeline

    rng = seed_everything(args.seed)
    b = load_sd_bundle(args)
    cfg = SDEditConfig(
        for_steps=args.for_steps, inv_steps=args.inv_steps,
        inv_refine_steps=args.inv_refine_steps,
        edit_t=args.edit_t, guidance_scale=args.guidance_scale,
        guidance_scale_edit=args.guidance_scale_edit,
        x_space_guidance_scale=args.x_space_guidance_scale,
        x_space_guidance_edit_step=args.x_space_guidance_edit_step,
        x_space_guidance_num_step=args.x_space_guidance_num_step,
        vis_num=args.vis_num, vis_num_pc=args.pca_rank,
        pca_rank=args.pca_rank, pca_rank_null=args.pca_rank_null,
        null_space_projection=args.null_space_projection,
        use_sega=args.use_sega,
        tilda_v_score_type=args.tilda_v_score_type
        or "null+(for-null)+(edit-null)",
        memory_bound=args.memory_bound,
        probe_chunk=args.probe_chunk or None,
        mesh_probe=args.mesh_probe, mesh_data=args.mesh_data,
        pixel_output=args.pixel_output,
        result_folder=args.result_folder)
    pipe = SDEditPipeline(b["unet_apply"], b["decode"], b["encode"],
                          b["prompt_encoder"], cfg, rng,
                          latent_shape=b["latent_shape"], device=args.device)
    return pipe, b, rng


def build_lcm_pipeline(args):
    from loco_edit_tpu_torch.core.rng import seed_everything
    from loco_edit_tpu_torch.models.t2i_registry import load_sd_bundle
    from loco_edit_tpu_torch.pipelines.lcm import LCMEditConfig, LCMEditPipeline

    rng = seed_everything(args.seed)
    b = load_sd_bundle(args, lcm=True)
    cfg = LCMEditConfig(
        num_inference_steps=args.num_inference_steps,
        edit_t_idx=args.edit_t_idx, guidance_scale=args.guidance_scale,
        x_space_guidance_scale=args.x_space_guidance_scale,
        x_space_guidance_num_step=args.x_space_guidance_num_step,
        vis_num=args.vis_num, pca_rank=args.pca_rank,
        pca_rank_null=args.pca_rank_null,
        null_space_projection=args.null_space_projection,
        non_semantic=args.non_semantic, use_sega=args.use_sega,
        memory_bound=args.memory_bound,
        probe_chunk=args.probe_chunk or None,
        mesh_probe=args.mesh_probe, mesh_data=args.mesh_data,
        pixel_output=args.pixel_output,
        result_folder=args.result_folder)
    pipe = LCMEditPipeline(b["unet_apply"], b["decode"], b["prompt_encoder"], cfg,
                           rng, latent_shape=b["latent_shape"], device=args.device)
    return pipe, b, rng


def build_if_pipeline(args):
    from loco_edit_tpu_torch.core.rng import seed_everything
    from loco_edit_tpu_torch.models.t2i_registry import load_if_bundle
    from loco_edit_tpu_torch.pipelines.deepfloyd import IFEditConfig, IFEditPipeline

    rng = seed_everything(args.seed)
    b = load_if_bundle(args)
    cfg = IFEditConfig(
        for_steps=args.for_steps, edit_t=args.edit_t,
        guidance_scale=args.guidance_scale,
        guidance_scale_edit=args.guidance_scale_edit,
        x_space_guidance_scale=args.x_space_guidance_scale,
        x_space_guidance_edit_step=args.x_space_guidance_edit_step,
        x_space_guidance_num_step=args.x_space_guidance_num_step,
        vis_num=args.vis_num, pca_rank=args.pca_rank,
        pca_rank_null=args.pca_rank_null,
        null_space_projection=args.null_space_projection,
        tilda_v_score_type=args.tilda_v_score_type or "(for-edit)-direct",
        jacobian=args.jacobian, probe_chunk=args.probe_chunk or None,
        mesh_probe=args.mesh_probe, mesh_data=args.mesh_data,
        memory_bound=args.memory_bound, pixel_output=args.pixel_output,
        result_folder=args.result_folder)
    pipe = IFEditPipeline(b["unet_apply"], b["prompt_encoder"], cfg, rng,
                          sample_shape=b["sample_shape"], superres=b["superres"],
                          device=args.device)
    return pipe, b, rng


def _t2i_mask_path(args) -> str:
    return os.path.join(args.result_folder, "mask", "mask.npz")


def _t2i_cached_mask(args):
    """The cached T2I edit mask (result_folder/mask/mask.npz, "masks" (n, H,
    W, 3) bool; --mask_index picks one), or None on a cold cache. Called
    before the models are built: a bad cache, or on a cold one SAM flags
    that cannot run, fail fast."""
    from loco_edit_tpu_torch.masks.sam import check_sam_source

    if os.path.exists(_t2i_mask_path(args)):
        return _read_mask(_t2i_mask_path(args), args.mask_index)
    check_sam_source(args.mask_backend, args.mask_model_name)
    return None


def _t2i_mask(args, x0: np.ndarray) -> np.ndarray:
    """Two-phase SAM protocol for the T2I engines (reference edit.py:941-956):
    SAM on the generated image x0 ((1, H, W, 3) in [-1, 1]), every mask
    cached at the image's side; with --sampling_mode exit 0, else go on
    with --mask_index."""
    from loco_edit_tpu_torch.masks.sam import extract_and_cache_masks

    extract_and_cache_masks(args, x0, _t2i_mask_path(args), resolution=x0.shape[1])
    if args.sampling_mode:
        print("sampling_mode: masks extracted; rerun with --mask_index")
        sys.exit(0)
    return _read_mask(_t2i_mask_path(args), args.mask_index)


def _main_sd(args) -> dict:
    semantic = args.run_edit_null_space_projection_zt_semantic
    edit = args.run_edit_null_space_projection_zt or semantic
    mask = _t2i_cached_mask(args) if edit and args.use_mask else None
    pipe, b, rng = build_sd_pipeline(args)
    results = {"timings": {}}
    if args.run_ddim_forward:
        zT = rng.fork("fwd").normal((5,) + tuple(b["latent_shape"]), device=pipe.device)
        img = pipe.decode_to_image(pipe.generate(
            zT, pipe.prompt_set(args.for_prompt, args.edit_prompt), "null+(for-null)"))
        _save_grid(img, os.path.join(args.result_folder, "DDIMforward.png"))
        results["forward"] = img
    if edit:
        if args.use_mask and mask is None:
            mask = _t2i_mask(args, pipe.decode_to_image(pipe.generate(
                rng.fork("zT").normal((1,) + tuple(b["latent_shape"]), device=pipe.device),
                pipe.prompt_set(args.for_prompt, args.edit_prompt), "null+(for-null)")))
        results["edit"] = pipe.run_edit_null_space_projection_zt(
            args.for_prompt, args.edit_prompt, mask=mask, semantic=semantic,
            vT_path=args.vT_path or None)
        results["timings"]["edit"] = dict(pipe.timings)
    return results


def _main_lcm(args) -> dict:
    edit = args.run_edit_null_space_projection_zt
    mask = _t2i_cached_mask(args) if edit and args.use_mask else None
    pipe, b, rng = build_lcm_pipeline(args)
    results = {"timings": {}}
    if args.run_ddim_forward:
        # a batch of samples as a model-load check (the reference's LCMforward)
        zT = rng.fork("fwd").normal((5,) + tuple(b["latent_shape"]), device=pipe.device)
        img = pipe.decode_to_image(pipe.forward_steps(zT, args.for_prompt)[1])
        _save_grid(img, os.path.join(args.result_folder, "LCMforward.png"))
        results["forward"] = img
    if edit:
        if args.use_mask and mask is None:
            mask = _t2i_mask(args, pipe.decode_to_image(pipe.forward_steps(
                rng.fork("zT").normal((1,) + tuple(b["latent_shape"]), device=pipe.device),
                args.for_prompt)[1]))
        results["edit"] = pipe.run_edit_null_space_projection_zt(
            args.for_prompt, args.edit_prompt, mask=mask, vT_path=args.vT_path or None)
        results["timings"]["edit"] = dict(pipe.timings)
    return results


def _main_if(args) -> dict:
    semantic = args.run_edit_null_space_projection_xt_semantic
    edit = args.run_edit_null_space_projection_xt or semantic
    diffedit = args.mask_type == "diffedit"
    mask = _t2i_cached_mask(args) if edit and args.use_mask and not diffedit else None
    pipe, b, rng = build_if_pipeline(args)
    results = {"timings": {}}
    if args.run_ddim_forward:
        xT = rng.fork("fwd").normal((5,) + tuple(b["sample_shape"]), device=pipe.device)
        img = pipe.forward_steps(xT, pipe.prompt_set(args.for_prompt, args.edit_prompt),
                                 "null+(for-null)").cpu().numpy()
        _save_grid(img, os.path.join(args.result_folder, "IFforward.png"))
        results["forward"] = img
    if edit:
        if args.use_mask and diffedit:
            # the DiffEdit mask of the sample the edit starts from (the same
            # "xT" stream), repeated over the 3 channels
            prompts = pipe.prompt_set(args.for_prompt, args.edit_prompt)
            xT = rng.fork("xT").normal((1,) + tuple(b["sample_shape"]), device=pipe.device)
            x0 = pipe.forward_steps(xT, prompts, "null+(for-null)")
            mask = np.repeat(pipe.diffedit_mask(x0, prompts), 3, axis=-1)
            results["mask"] = mask
        elif args.use_mask and mask is None:
            mask = _t2i_mask(args, pipe.forward_steps(
                rng.fork("xT").normal((1,) + tuple(b["sample_shape"]), device=pipe.device),
                pipe.prompt_set(args.for_prompt, args.edit_prompt), "null+(for-null)")
                .cpu().numpy())
        ablation = args.ablation_method if args.ablation_method in ("diffedit", "sega") \
            else None
        results["edit"] = pipe.run_edit_null_space_projection_xt(
            args.for_prompt, args.edit_prompt, mask=mask, semantic=semantic,
            ablation=ablation, vT_path=args.vT_path or None)
        results["timings"]["edit"] = dict(pipe.timings)
    return results


if __name__ == "__main__":
    main()

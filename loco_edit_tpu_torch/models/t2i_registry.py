"""T2I model bundles for the CLI (port of
loco_edit_tpu/models/t2i_registry.py): SD 2.1-base, LCM Dreamshaper v7 and
DeepFloyd-IF (stage 1 and the stage-2 upscaler).

Local checkpoint paths only: --checkpoint_path for the U-Net (a diffusers
state_dict `.pt`/`.pth`/`.bin`/`.ckpt`/`.safetensors`, or a `.npz` of Flax
parameters), --vae_path for the AutoencoderKL (a diffusers state_dict),
--text_encoder_path for CLIP or T5 (a transformers directory), and for IF
--stage2_checkpoint_path for the upscaler. A missing path gives seeded
random weights (U-Net seed 0, encoder 1, decoder 2; IF stage 1 seed 0,
stage 2 seed 3) at the preset's widths, and the deterministic fake prompt
encoder, enough to drive the whole engine. LOCO_SD_PRESET (e.g. `tiny`)
picks another SD / LCM U-Net preset, as in the JAX package. IF without
any checkpoint file is the pair LOCO-Edit serves, IF-I-M and the IF-II-L
upscaler; LOCO_IF_PRESET `tiny` makes it the tiny stage 1 without an
upscaler (the JAX package's IF default), `tiny,tiny` the tiny cascade. A
stage-1 checkpoint gets an upscaler only from --stage2_checkpoint_path.

Unlike the JAX package, the bundle leaves per-block rematerialization off:
torch.utils.checkpoint does not compose with torch.func's jvp and vmap, and
an 80 GB card holds the rank-5+5 basis through the 512 px decoder without it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from loco_edit_tpu_torch.core.device import resolve_device, use_full_f32
from loco_edit_tpu_torch.models.convert_util import check_state_dict
from loco_edit_tpu_torch.models.sd import (SDUNet, VAEConfig, VAEDecoder, VAEEncoder,
                                           encode_sample, sd_preset)
from loco_edit_tpu_torch.models.sd.text import (clip_prompt_encoder, fake_prompt_encoder,
                                                 t5_prompt_encoder)

TORCH_CKPT = (".pt", ".pth", ".bin", ".ckpt", ".safetensors")


def _torch_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name in ("bf16", "fp16") else torch.float32


def _load_unet(cfg, path: str, device: torch.device) -> SDUNet:
    with torch.device(device):
        model = SDUNet(cfg)
    if path:
        if path.endswith(TORCH_CKPT):
            from loco_edit_tpu_torch.models.adm.convert import load_torch_checkpoint
            from loco_edit_tpu_torch.models.sd.convert import convert_sd_unet_state_dict

            sd = convert_sd_unet_state_dict(load_torch_checkpoint(path), cfg)
        elif path.endswith(".npz"):
            from loco_edit_tpu_torch.models.sd.convert import sd_params_from_flax

            with np.load(path) as z:
                sd = sd_params_from_flax({k: z[k] for k in z.files}, cfg)
        else:
            raise ValueError(f"unsupported checkpoint format: {path}")
        check_state_dict(sd, model, f"checkpoint {path}")
        model.load_state_dict(sd)
    else:
        model.init_random_(torch.Generator(device).manual_seed(0))
    return model.requires_grad_(False).eval()


def _load_vae(cfg: VAEConfig, path: str, device: torch.device):
    with torch.device(device):
        enc, dec = VAEEncoder(cfg), VAEDecoder(cfg)
    if path:
        if not path.endswith(TORCH_CKPT):
            raise ValueError(f"unsupported VAE checkpoint format: {path}")
        from loco_edit_tpu_torch.models.adm.convert import load_torch_checkpoint
        from loco_edit_tpu_torch.models.sd.convert import convert_vae_state_dict

        pe, pd = convert_vae_state_dict(load_torch_checkpoint(path), cfg)
        enc.load_state_dict(pe)
        dec.load_state_dict(pd)
    else:
        enc.init_random_(torch.Generator(device).manual_seed(1))
        dec.init_random_(torch.Generator(device).manual_seed(2))
    return enc.requires_grad_(False).eval(), dec.requires_grad_(False).eval()


def sd_bundle(unet: SDUNet, enc: VAEEncoder, dec: VAEDecoder, prompt_encoder) -> dict:
    """The engine's callables over bound models: unet_apply(z, t, ctx[, w])
    (w: the LCM guidance scales, read by a U-Net with `cond_proj`),
    decode(z), encode(x, rng) (a sampled, scaled latent), the prompt
    encoder, the latent shape, and the models under "models"."""
    cfg = unet.cfg
    return {
        "unet_apply": lambda z, t, c, w=None: unet(z, t, c, w),
        "decode": lambda z: dec(z),
        "encode": lambda x, rng: encode_sample(*enc(x), rng,
                                               enc.cfg.scaling_factor),
        "prompt_encoder": prompt_encoder,
        "latent_shape": (cfg.sample_size, cfg.sample_size, cfg.out_channels),
        "models": {"unet": unet, "encoder": enc, "decoder": dec},
    }


def load_sd_bundle(args, lcm: bool = False) -> dict:
    """SD 2.1-base, or with lcm=True LCM Dreamshaper v7 (the SD 1.5 U-Net
    with the guidance embedding, `cond_proj`), or the LOCO_SD_PRESET preset,
    on args.device: U-Net, VAE at 8x the latent size, prompt encoder (the
    fake one is as wide as the preset's context: 1024 for SD 2.1, 768 for
    SD 1.5 and LCM). At f32 sets the port's f32 policy (use_full_f32)."""
    device = resolve_device(getattr(args, "device", "cuda"))
    dtype = _torch_dtype(args.dtype)
    use_full_f32(dtype)
    preset = os.environ.get("LOCO_SD_PRESET") or (
        "lcm-dreamshaper-v7" if lcm else "sd21-base")
    cfg = sd_preset(preset, dtype=dtype)
    unet = _load_unet(cfg, args.checkpoint_path, device)
    # the VAE follows the compute dtype, as the JAX bundle's does
    vae_cfg = VAEConfig(sample_size=cfg.sample_size * 8, dtype=dtype)
    enc, dec = _load_vae(vae_cfg, getattr(args, "vae_path", ""), device)
    path = getattr(args, "text_encoder_path", "")
    prompt_encoder = (clip_prompt_encoder(path, device=device) if path
                      else fake_prompt_encoder(cfg.cross_attention_dim, device=device))
    return sd_bundle(unet, enc, dec, prompt_encoder)


IF_PRESETS = ("IF-I-M", "IF-II-L")    # the pair LOCO-Edit serves


def if_configs(dtype: torch.dtype = torch.float32):
    """(stage-1 IFUNetConfig, stage-2 IFUNetConfig or None) of the models
    built without checkpoint files: IF_PRESETS, or with LOCO_IF_PRESET
    `tiny` the tiny stage 1 alone and with `tiny,tiny` the tiny cascade."""
    from loco_edit_tpu_torch.models.ifm import if_preset, tiny_if_config

    override = os.environ.get("LOCO_IF_PRESET", "")
    if not override:
        return tuple(if_preset(n, dtype=dtype) for n in IF_PRESETS)
    if override not in ("tiny", "tiny,tiny"):
        raise ValueError(f"LOCO_IF_PRESET {override!r}: `tiny` or `tiny,tiny`")
    return (tiny_if_config(dtype=dtype),
            tiny_if_config(stage2=True, dtype=dtype) if override == "tiny,tiny" else None)


def _load_if_model(path: str, cfg, dtype: torch.dtype, device: torch.device,
                   seed: int):
    """An IFUNet on `device` from a diffusers checkpoint (the geometry
    inferred from its shapes: presets never gate loading), or `cfg` with
    seeded random weights when no path is given."""
    from loco_edit_tpu_torch.models.ifm import (IFUNet, convert_if_state_dict,
                                                infer_if_config)

    if path:
        if not path.endswith(TORCH_CKPT):
            raise ValueError(f"unsupported IF checkpoint format: {path}")
        from loco_edit_tpu_torch.models.adm.convert import load_torch_checkpoint

        sd = load_torch_checkpoint(path)
        cfg = infer_if_config(sd, dtype=dtype)
        state = convert_if_state_dict(sd, cfg)
        del sd
        with torch.device(device):
            model = IFUNet(cfg)
        model.load_state_dict(state)
    else:
        with torch.device(device):
            model = IFUNet(cfg)
        model.init_random_(torch.Generator(device).manual_seed(seed))
    return model.requires_grad_(False).eval()


def load_if_bundle(args) -> dict:
    """DeepFloyd-IF on args.device: the stage-1 U-Net from
    --checkpoint_path, the T5 encoder from --text_encoder_path (else the
    fake encoder, as wide as the U-Net's encoder_hid_dim), and the stage-2
    upscaler sampler from --stage2_checkpoint_path; without a stage-1
    checkpoint, the if_configs() pair with seeded weights (IF-I-M with the
    IF-II-L upscaler, as the reference pairs them), a stage-2 checkpoint
    taking the upscaler's place. At f32 sets the port's f32 policy
    (use_full_f32)."""
    from loco_edit_tpu_torch.core.rng import RngStream
    from loco_edit_tpu_torch.pipelines.superres import SuperResSampler

    device = resolve_device(getattr(args, "device", "cuda"))
    dtype = _torch_dtype(args.dtype)
    use_full_f32(dtype)
    # a stage-1 checkpoint's geometry is its own, and it is upscaled only
    # by a stage-2 checkpoint, never by a seeded preset
    cfg1, cfg2 = (None, None) if args.checkpoint_path else if_configs(dtype)
    model = _load_if_model(args.checkpoint_path, cfg1, dtype, device, 0)
    cfg = model.cfg
    path = getattr(args, "text_encoder_path", "")
    prompt_encoder = (t5_prompt_encoder(path, device=device) if path
                      else fake_prompt_encoder(cfg.encoder_hid_dim, device=device))
    bundle = {
        "unet_apply": lambda x, t, c: model(x, t, c),
        "prompt_encoder": prompt_encoder,
        "sample_shape": (cfg.sample_size, cfg.sample_size, 3),
        "superres": None,
        "models": {"unet": model},
    }
    s2_path = getattr(args, "stage2_checkpoint_path", "")
    if s2_path or cfg2 is not None:
        m2 = _load_if_model(s2_path, cfg2, dtype, device, 3)
        bundle["superres"] = SuperResSampler(
            lambda x, t, c, aug_t: m2(x, t, c, aug_t), prompt_encoder,
            out_size=m2.cfg.sample_size,
            # stage-2 CFG is its own knob: the reference upscales at the
            # diffusers IFSuperResolutionPipeline default (4.0)
            guidance_scale=getattr(args, "stage2_guidance_scale", 4.0),
            aug_level=250,  # diffusers IFSuperResolutionPipeline default
            rng=RngStream.from_seed(args.seed), device=device)
        bundle["models"]["stage2"] = m2
    return bundle

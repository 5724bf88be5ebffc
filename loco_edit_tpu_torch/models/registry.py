"""Model registry: model_name -> bound Denoiser (port of the uncond part of
loco_edit_tpu/models/registry.py).

P2/ImageNet/LSUN names resolve to ADM presets, the *_HF names to the
SDEdit-style DDPM U-Net family, "TinyTest" to the 32px tiny ADM.
Checkpoints are local files: a torch guided-diffusion state_dict
(`.pt`/`.pth`/`.ckpt`/`.safetensors`, converted by models/adm/convert.py)
or a `.npz` of Flax parameters as the JAX package's `save_params_npz`
writes them (carried by `adm_params_from_flax`). With no checkpoint the
model gets seeded random weights (`ADMUNet.init_random_`).
"""

from __future__ import annotations

import numpy as np
import torch

from loco_edit_tpu_torch.core.device import resolve_device, use_full_f32
from loco_edit_tpu_torch.models.adm import ADMUNet, adm_preset
from loco_edit_tpu_torch.models.adm.presets import tiny_test_config
from loco_edit_tpu_torch.models.base import Denoiser
from loco_edit_tpu_torch.models.convert_util import check_state_dict, flax_to_state_dict

ADM_NAMES = ("FFHQ_P2", "AFHQ_P2", "Flower_P2", "Cub_P2", "Metface_P2",
             "ImageNet256Uncond", "ImageNet256Cond", "ImageNet128Cond",
             "ImageNet64Cond", "LSUN_bedroom", "LSUN_cat", "LSUN_horse")
DDPM_HF_NAMES = ("CelebA_HQ_HF", "LSUN_church_HF", "LSUN_bedroom_HF", "FFHQ_HF")


def adm_params_from_flax(flat: dict[str, np.ndarray], cfg) -> dict[str, torch.Tensor]:
    """Carry a flat Flax ADM parameter dict to an ADMUNet state_dict
    (models/convert_util.py::flax_to_state_dict). The Flax qkv kernel is
    already q|k|v-contiguous, so the qkv Linear keeps that packing. Raises
    ValueError unless the result matches the module tree of `cfg` key for
    key and shape for shape."""
    return _from_flax(flat, lambda: ADMUNet(cfg))


def superres_params_from_flax(flat: dict[str, np.ndarray], cfg) -> dict[str, torch.Tensor]:
    """A SuperResADMUNet(cfg) state_dict from its flat Flax parameters (the
    wrapped U-Net under the "unet/" prefix)."""
    from loco_edit_tpu_torch.models.adm.variants import SuperResADMUNet

    return _from_flax(flat, lambda: SuperResADMUNet(cfg))


def encoder_params_from_flax(flat: dict[str, np.ndarray], cfg, head) -> dict[str, torch.Tensor]:
    """An EncoderADMUNet(cfg, head) state_dict from its flat Flax parameters."""
    from loco_edit_tpu_torch.models.adm.variants import EncoderADMUNet

    return _from_flax(flat, lambda: EncoderADMUNet(cfg, head))


def _from_flax(flat, build) -> dict[str, torch.Tensor]:
    sd = flax_to_state_dict(flat)
    with torch.device("meta"):
        check_state_dict(sd, build(), "Flax params")
    return sd


def _adm_state_dict_from_file(path: str, cfg) -> dict[str, torch.Tensor]:
    if path.endswith((".pt", ".pth", ".ckpt", ".safetensors")):
        from loco_edit_tpu_torch.models.adm.convert import (
            convert_adm_state_dict,
            load_torch_checkpoint,
        )

        return convert_adm_state_dict(load_torch_checkpoint(path), cfg)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return adm_params_from_flax({k: z[k] for k in z.files}, cfg)
    raise ValueError(f"unsupported checkpoint format: {path}")


def _bind(model: ADMUNet, device: torch.device) -> Denoiser:
    cfg = model.cfg
    model.requires_grad_(False).eval()
    return Denoiser(eps_fn=lambda x, t: model(x, t),
                    sample_shape=(cfg.image_size, cfg.image_size, cfg.in_channels),
                    device=device, learn_sigma=cfg.learn_sigma,
                    meta={"cfg": cfg, "model": model})


def load_adm_denoiser(model_name: str, checkpoint_path: str = "",
                      dtype: torch.dtype = torch.float32,
                      device: str | torch.device = "cuda",
                      seed: int = 0) -> Denoiser:
    """An ADM preset by name, with weights from a checkpoint or, with none,
    seeded random weights. Runs on the card unless device="cpu"; at f32
    sets the port's f32 policy (core/device.py::use_full_f32)."""
    dev = resolve_device(device)
    use_full_f32(dtype)
    cfg = adm_preset(model_name, dtype=dtype)
    with torch.device(dev):
        model = ADMUNet(cfg)
    if checkpoint_path:
        sd = _adm_state_dict_from_file(checkpoint_path, cfg)
        check_state_dict(sd, model, f"checkpoint {checkpoint_path}")
        model.load_state_dict(sd)
    else:
        model.init_random_(torch.Generator(dev).manual_seed(seed))
    return _bind(model, dev)


def load_tiny_denoiser(dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cuda",
                       seed: int = 0) -> Denoiser:
    """32px tiny ADM ("TinyTest") with seeded random weights + 0.02."""
    dev = resolve_device(device)
    use_full_f32(dtype)
    cfg = tiny_test_config(dtype=dtype)
    with torch.device(dev):
        model = ADMUNet(cfg)
    model.init_random_(torch.Generator(dev).manual_seed(seed))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02)
    return _bind(model, dev)


def load_denoiser(args) -> Denoiser:
    """CLI entry: resolve args.model_name to a Denoiser on args.device."""
    dtype = torch.bfloat16 if args.dtype in ("bf16", "fp16") else torch.float32
    if args.model_name == "TinyTest":
        return load_tiny_denoiser(dtype, device=args.device)
    if args.model_name in ADM_NAMES:
        return load_adm_denoiser(args.model_name, args.checkpoint_path, dtype,
                                 device=args.device)
    if args.model_name in DDPM_HF_NAMES:
        from loco_edit_tpu_torch.models.ddpm import load_ddpm_denoiser

        return load_ddpm_denoiser(args.model_name, args.checkpoint_path, dtype,
                                  device=args.device)
    raise NotImplementedError(
        f"model family for {args.model_name!r} not wired into the registry yet")

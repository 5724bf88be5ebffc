"""DDPM model loading by reference model name (port of
loco_edit_tpu/models/ddpm/loader.py).

The *_HF names resolve to google/ddpm-ema-* checkpoints in the reference;
all share the classic 256px DDPM architecture. Checkpoints are local files:
a torch `.pt`/`.pth`/`.ckpt`/`.bin` in SDEdit or diffusers naming (converted
by models/ddpm/convert.py), or a `.npz` of Flax parameters as the JAX
package's `save_params_npz` writes them. Without one the model gets seeded
random weights.
"""

from __future__ import annotations

import numpy as np
import torch

from loco_edit_tpu_torch.core.device import resolve_device, use_full_f32
from loco_edit_tpu_torch.models.base import Denoiser
from loco_edit_tpu_torch.models.convert_util import check_state_dict, flax_to_state_dict
from loco_edit_tpu_torch.models.ddpm.unet import DDPMConfig, DDPMUNet

_DDPM_256 = dict(resolution=256, in_channels=3, out_ch=3, ch=128,
                 ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
                 attn_resolutions=(16,), resamp_with_conv=True)

DDPM_PRESETS: dict[str, dict] = {
    "CelebA_HQ_HF": _DDPM_256,
    "LSUN_church_HF": _DDPM_256,
    "LSUN_bedroom_HF": _DDPM_256,
    "FFHQ_HF": _DDPM_256,
    "CelebA_HQ": _DDPM_256,          # SDEdit YAML config (custom_celeba_ddpm.yml)
    "LSUN_church": _DDPM_256,
    "LSUN_bedroom": _DDPM_256,
}


def ddpm_preset(name: str, dtype: torch.dtype = torch.float32) -> DDPMConfig:
    if name not in DDPM_PRESETS:
        raise ValueError(f"unknown DDPM preset {name!r}")
    return DDPMConfig(dtype=dtype, **DDPM_PRESETS[name])


def ddpm_state_dict_from_file(path: str, cfg: DDPMConfig) -> dict[str, torch.Tensor]:
    """A DDPMUNet state_dict from a torch checkpoint (either naming) or a
    Flax `.npz`."""
    if path.endswith((".pt", ".pth", ".ckpt", ".bin")):
        from loco_edit_tpu_torch.models.adm.convert import load_torch_checkpoint
        from loco_edit_tpu_torch.models.ddpm.convert import (
            convert_ddpm_state_dict,
            convert_diffusers_unet2d_state_dict,
        )

        sd = load_torch_checkpoint(path)
        conv = (convert_diffusers_unet2d_state_dict
                if any(k.startswith("time_embedding.") for k in sd)
                else convert_ddpm_state_dict)
        return conv(sd, cfg)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return flax_to_state_dict({k: z[k] for k in z.files})
    raise ValueError(f"unsupported checkpoint: {path}")


def load_ddpm_denoiser(model_name: str, checkpoint_path: str = "",
                       dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cuda",
                       seed: int = 0) -> Denoiser:
    """A DDPM preset by name with weights from a checkpoint or, with none,
    seeded random weights. Runs on the card unless device="cpu"; at f32
    sets the port's f32 policy (core/device.py::use_full_f32)."""
    dev = resolve_device(device)
    use_full_f32(dtype)
    cfg = ddpm_preset(model_name, dtype)
    with torch.device(dev):
        model = DDPMUNet(cfg)
    if checkpoint_path:
        sd = ddpm_state_dict_from_file(checkpoint_path, cfg)
        check_state_dict(sd, model, f"checkpoint {checkpoint_path}")
        model.load_state_dict(sd)
    else:
        model.init_random_(torch.Generator(dev).manual_seed(seed))
    model.requires_grad_(False).eval()
    return Denoiser(eps_fn=lambda z, t: model(z, t),
                    sample_shape=(cfg.resolution, cfg.resolution, cfg.in_channels),
                    device=dev, learn_sigma=False,
                    meta={"cfg": cfg, "model": model})

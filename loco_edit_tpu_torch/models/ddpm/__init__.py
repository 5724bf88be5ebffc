from loco_edit_tpu_torch.models.ddpm.unet import DDPMConfig, DDPMUNet, ddpm_timestep_embedding
from loco_edit_tpu_torch.models.ddpm.convert import (
    convert_ddpm_state_dict,
    convert_diffusers_unet2d_state_dict,
)
from loco_edit_tpu_torch.models.ddpm.loader import (
    DDPM_PRESETS,
    ddpm_preset,
    load_ddpm_denoiser,
)

__all__ = [
    "DDPMConfig",
    "DDPMUNet",
    "ddpm_timestep_embedding",
    "convert_ddpm_state_dict",
    "convert_diffusers_unet2d_state_dict",
    "load_ddpm_denoiser",
    "ddpm_preset",
    "DDPM_PRESETS",
]

from loco_edit_tpu_torch.diffusion.schedule import (
    linear_betas,
    cosine_betas,
    alphas_cumprod_from_betas,
    NoiseSchedule,
)
from loco_edit_tpu_torch.diffusion.scheduler import (
    LinspaceDDIM,
    TimestepGrid,
    ddim_step,
    ddpm_step_learned_sigma,
    pmp,
)
from loco_edit_tpu_torch.diffusion.sampling import ddim_generate, ddim_invert
from loco_edit_tpu_torch.diffusion.losses import GaussianDiffusionMath
from loco_edit_tpu_torch.diffusion.respace import respaced_schedule
from loco_edit_tpu_torch.diffusion.ancestral import p_sample_scan

__all__ = [
    "linear_betas",
    "cosine_betas",
    "alphas_cumprod_from_betas",
    "NoiseSchedule",
    "LinspaceDDIM",
    "TimestepGrid",
    "ddim_step",
    "ddpm_step_learned_sigma",
    "pmp",
    "ddim_generate",
    "ddim_invert",
    "GaussianDiffusionMath",
    "respaced_schedule",
    "p_sample_scan",
]

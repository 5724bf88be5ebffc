"""Latent Consistency Model scheduler, few-step (port of
loco_edit_tpu/diffusion/lcm.py).

The diffusers LCMScheduler as the LCM engine keeps it:

  - timestep selection: k = train_steps / original_steps (= 20); the origin
    grid arange(1..50) * 20 - 1, reversed, strided by 50 // n, e.g.
    [999, 759, 519, 279] for n = 4.
  - consistency step: denoised = c_out * x0_pred + c_skip * sample, with
    the boundary scalings of scaled_t = t * timestep_scaling (10) and
    sigma_data 0.5; then re-noised to the next grid point, except at the
    last step.

The grid is host numpy, bit-equal to the JAX package's; the steps are torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from loco_edit_tpu_torch.diffusion.schedule import NoiseSchedule


@dataclasses.dataclass(frozen=True)
class LCMGrid:
    t: np.ndarray               # (S,) int timesteps, descending
    alpha_bar: np.ndarray       # (S,)
    alpha_bar_prev: np.ndarray  # (S,) next grid point's abar (last = own)
    c_skip: np.ndarray          # (S,)
    c_out: np.ndarray           # (S,)

    def __len__(self) -> int:
        return int(self.t.shape[0])


def lcm_grid(num_inference_steps: int, schedule: NoiseSchedule | None = None,
             original_inference_steps: int = 50, timestep_scaling: float = 10.0,
             sigma_data: float = 0.5) -> LCMGrid:
    # the LCM Dreamshaper checkpoint's scheduler is scaled_linear
    schedule = schedule or NoiseSchedule.scaled_linear(
        beta_start=0.00085, beta_end=0.012, timesteps=1000)
    k = schedule.num_train_timesteps // original_inference_steps
    origin = np.arange(1, original_inference_steps + 1) * k - 1
    skip = original_inference_steps // num_inference_steps
    t = origin[::-1][::skip][:num_inference_steps].astype(np.int64)

    ab = schedule.alphas_cumprod[t].astype(np.float32)
    ab_prev = np.concatenate([ab[1:], ab[-1:]])
    scaled = t.astype(np.float64) * timestep_scaling
    c_skip = (sigma_data**2 / (scaled**2 + sigma_data**2)).astype(np.float32)
    c_out = (scaled / np.sqrt(scaled**2 + sigma_data**2)).astype(np.float32)
    return LCMGrid(t=t, alpha_bar=ab, alpha_bar_prev=ab_prev,
                   c_skip=c_skip, c_out=c_out)


def lcm_denoised(sample: torch.Tensor, eps_pred: torch.Tensor, grid: LCMGrid,
                 step_idx: int) -> torch.Tensor:
    """The consistency-model output at one grid step (the LCM 'x0'); the
    scalars are f32, as the JAX step forms them."""
    ab = np.float32(grid.alpha_bar[step_idx])
    x0_pred = ((sample - float(np.sqrt(np.float32(1.0) - ab)) * eps_pred)
               / float(np.sqrt(ab)))
    return (float(grid.c_out[step_idx]) * x0_pred
            + float(grid.c_skip[step_idx]) * sample)


def lcm_scan(eps_fn, z: torch.Tensor, grid: LCMGrid, rng, start_idx: int = 0,
             end_idx: int | None = None, noise_fn=None):
    """Run LCM steps [start_idx, end_idx); returns (z_next, denoised_last).
    The inter-step noise of step i is `rng.at_step(i)`'s draw (the JAX
    scan's fold_in(key, i)); the final grid step returns denoised directly
    (diffusers LCMScheduler.step).

    noise_fn(step_idx, shape, dtype) -> array overrides the inter-step
    noise draw, so that tests can inject one implementation's noise into
    the other's sampler."""
    s = len(grid)
    end = s if end_idx in (None, -1) else end_idx
    z_cur, den = z, z
    for i in range(start_idx, end):
        eps = eps_fn(z_cur, float(grid.t[i]))
        den = lcm_denoised(z_cur, eps, grid, i)
        if i != s - 1:
            if noise_fn is not None:
                noise = torch.as_tensor(np.asarray(noise_fn(i, tuple(z_cur.shape),
                                                            np.float32)),
                                        device=z_cur.device, dtype=z_cur.dtype)
            else:
                noise = rng.at_step(i).normal(z_cur.shape, device=z_cur.device,
                                              dtype=z_cur.dtype)
            abp = np.float32(grid.alpha_bar_prev[i])
            z_cur = (float(np.sqrt(abp)) * den
                     + float(np.sqrt(np.float32(1.0) - abp)) * noise)
        else:
            z_cur = den
    return z_cur, den

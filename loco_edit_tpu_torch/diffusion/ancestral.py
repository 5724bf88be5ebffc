"""Ancestral (DDPM) sampling loop with optional classifier guidance (port of
loco_edit_tpu/diffusion/ancestral.py).

The reference's p_sample / p_sample_loop and its classifier-guidance hook
(guided_diffusion/gaussian_diffusion.py:327-536, condition_mean :356-370).
A host loop over the timesteps, which are integer indices into the
(possibly respaced) schedule; the JAX package scans the same body.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from loco_edit_tpu_torch.core.device import resolve_device
from loco_edit_tpu_torch.diffusion.losses import GaussianDiffusionMath


def p_sample_scan(eps_fn: Callable, x: torch.Tensor,
                  math_: GaussianDiffusionMath, rng,
                  timesteps: np.ndarray | None = None,
                  logvar_frac_fn: Callable | None = None,
                  cond_grad_fn: Callable | None = None,
                  guidance_scale: float = 1.0,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """Sample x0 ~ p(x0 | xT) ancestrally from x = xT, on `device`.

    eps_fn(x, t_int_batch) -> eps; logvar_frac_fn(x, t) -> the learned
    variance fraction in [-1, 1] (None: the fixed posterior variance);
    cond_grad_fn(x, t) -> grad_x log p(y | x) for classifier guidance, the
    mean shifted by variance * scale * grad (the reference's condition_mean).
    The step at t draws its noise from `rng.at_step(t)` (a core/rng.py
    RngStream). The networks run under no_grad; cond_grad_fn takes its own
    gradient."""
    x = x.to(resolve_device(device))
    n = math_.schedule.num_train_timesteps
    ts = np.arange(n - 1, -1, -1) if timesteps is None else np.asarray(timesteps)
    for t in ts.tolist():
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        with torch.no_grad():
            eps = eps_fn(x, tb)
            frac = logvar_frac_fn(x, tb) if logvar_frac_fn is not None else None
            mean, logvar, _ = math_.p_mean_logvar(x, tb, eps, model_logvar_frac=frac)
        if cond_grad_fn is not None:
            mean = mean + torch.exp(logvar) * guidance_scale * cond_grad_fn(x, tb)
        noise = rng.at_step(t).normal(x.shape, device=x.device, dtype=x.dtype)
        x = mean + float(t != 0) * torch.exp(0.5 * logvar) * noise
    return x

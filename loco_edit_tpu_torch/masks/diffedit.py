"""DiffEdit-style mask from prompt-conditional epsilon differences (port of
loco_edit_tpu/masks/diffedit.py).

Noise x0 to t = 500 with a 10-sample noise batch, compare the CFG epsilon
under the 'for' prompt with the one under the 'edit' prompt, average over
the batch and the channels, min-max normalize and threshold. The
reference's normalization has an operator-precedence slip (`mask -
mask.min() / ...`); this is the intended min-max normalization, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def diffedit_mask(eps_fn_for, eps_fn_edit, x0: torch.Tensor, alphas_cumprod, rng,
                  *, t: int = 500, n_noise: int = 10,
                  threshold: float = 0.5) -> torch.Tensor:
    """eps_fn_for / eps_fn_edit: (x, t) -> epsilon under the two prompts;
    rng: the stream of the noise batch. Returns a bool mask (1, H, W, 1)."""
    ab = np.float32(alphas_cumprod[t])
    noise = rng.normal((n_noise, *x0.shape[1:]), device=x0.device, dtype=x0.dtype)
    xt = float(np.sqrt(ab)) * x0 + float(np.sqrt(np.float32(1.0) - ab)) * noise
    e1 = eps_fn_for(xt, float(t))
    e2 = eps_fn_edit(xt, float(t))
    diff = (e1 - e2).abs().mean(dim=0, keepdim=True).mean(dim=-1, keepdim=True)
    d = (diff - diff.min()) / (diff.max() - diff.min() + 1e-12)
    return d >= threshold

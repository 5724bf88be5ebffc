"""The latent consistency sampler of LCM Dreamshaper v7, plain: the
reference the benchmark holds the served LCM steps to. Imports nothing of
the program.

The grid: the scaled-linear beta schedule (sqrt-beta linspace 0.00085 to
0.012 over 1000 steps); of the 50 original timesteps (20 k - 1), reversed,
every 50 // n-th, n of them ([999, 759, 519, 279] for n = 4). A step: x0 =
(z - sqrt(1 - ab) eps) / sqrt(ab); denoised = c_out x0 + c_skip z with the
boundary scalings at 10 t and sigma_data 0.5; then re-noised to the next
grid point with the draw of stream.at_step(i), except at the last step.
"""

from __future__ import annotations

import numpy as np
import torch


class Grid:
    def __init__(self, n: int):
        ab = np.cumprod(1.0 - np.linspace(np.sqrt(0.00085), np.sqrt(0.012), 1000,
                                          dtype=np.float64) ** 2)
        t = (np.arange(1, 51) * 20 - 1)[::-1][::50 // n][:n].astype(np.int64)
        self.t = t
        self.ab = ab[t].astype(np.float32)
        self.ab_prev = np.concatenate([self.ab[1:], self.ab[-1:]])
        scaled = t.astype(np.float64) * 10.0
        self.c_skip = (0.25 / (scaled ** 2 + 0.25)).astype(np.float32)
        self.c_out = (scaled / np.sqrt(scaled ** 2 + 0.25)).astype(np.float32)

    def __len__(self) -> int:
        return len(self.t)


def denoised(z, eps, grid: Grid, i: int):
    ab = np.float32(grid.ab[i])
    x0 = (z - float(np.sqrt(np.float32(1.0) - ab)) * eps) / float(np.sqrt(ab))
    return float(grid.c_out[i]) * x0 + float(grid.c_skip[i]) * z


@torch.no_grad()
def steps(eps_fn, z, grid: Grid, start: int, end: int, stream):
    """Steps [start, end) from z; returns (z after them, the last denoised)."""
    den = z
    for i in range(start, end):
        den = denoised(z, eps_fn(z, float(grid.t[i])), grid, i)
        if i != len(grid) - 1:
            ap = np.float32(grid.ab_prev[i])
            z = (float(np.sqrt(ap)) * den
                 + float(np.sqrt(np.float32(1.0) - ap)) * stream.at_step(i).normal(
                     z.shape, z.device))
        else:
            z = den
    return z, den

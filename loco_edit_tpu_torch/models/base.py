"""The denoiser interface the edit algebra is written against (port of
loco_edit_tpu/models/base.py)."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

# eps_fn(x, t) -> epsilon; x (B,H,W,C) in the model's native space, t scalar.
EpsFn = Callable[[torch.Tensor, float], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Denoiser:
    """A bound denoiser: weights are closed over, conditioning applied."""

    eps_fn: EpsFn
    sample_shape: tuple[int, int, int]  # (H, W, C) of the model's state space
    device: torch.device
    learn_sigma: bool = False
    meta: Any = None


@torch.no_grad()
def init_random_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: every conv / dense / embedding weight from a
    truncated normal of variance 1/fan_in (Flax's lecun_normal), biases
    zero, GroupNorm and LayerNorm affine left at (1, 0). Unlike the JAX package's init, the
    zero-initialized output layers (ResBlock out_conv, proj_out, the final
    conv) get the same random weights, so eps is not identically zero and
    every layer reaches the output and the Jacobian."""
    std_trunc = 0.87962566103423978   # std of a unit normal cut at +-2
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / std_trunc
            w = torch.empty(m.weight.shape, dtype=torch.float32,
                            device=m.weight.device)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(generator=generator)

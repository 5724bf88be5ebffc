"""Normalization ops (port of loco_edit_tpu/ops/norms.py).

The ADM family normalizes in float32 whatever the compute dtype (32 groups,
eps 1e-5). The work is done by ops/groupnorm.py: the plain version on the
CPU, the CUDA kernel on the card, with hand-written differentiation rules;
with a process group the kernel's statistics and normalize passes run as
separate launches with an all-reduce between them.
"""

from __future__ import annotations

import torch
from torch.overrides import handle_torch_function, has_torch_function_variadic

from loco_edit_tpu_torch.ops.groupnorm import GroupNormFn


def group_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-5, *,
                   group=None) -> torch.Tensor:
    """GroupNorm over the channel axis (dim 1) of a (B, C, H, W) tensor,
    computed in float32 and returned in x.dtype. With a process group, x
    is this rank's band of rows (dim 2) and the statistics are those of
    every rank's rows. Overridable by a TorchFunctionMode, which is how
    spatial parallelism (parallel/sp.py) passes its group."""
    if has_torch_function_variadic(x, scale, bias):
        return handle_torch_function(group_norm_f32, (x, scale, bias), x, scale, bias,
                                     num_groups, eps, group=group)
    return GroupNormFn.apply(x, scale, bias, num_groups, eps, group)

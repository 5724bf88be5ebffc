"""Cross-rank consistency checks (port of loco_edit_tpu/parallel/checks.py).

Replicated parameters stay in sync when every rank applies the same update,
but silent divergence (rank-dependent data order feeding a replicated
update, a missed all-reduce) is worth an assertion in long runs.
`replicated_params_checksum` is one scalar digest; comparing it across ranks
or across steps catches drift. It is the JAX package's formula over the
parameters in `named_parameters()` order; the value differs from the JAX
package's, whose layouts (HWIO, (I, O)) order the elements differently.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch
from torch import nn


def replicated_params_checksum(params: nn.Module | Mapping[str, torch.Tensor]
                               | Iterable[torch.Tensor]) -> torch.Tensor:
    """f32 scalar: sum over leaves i of (sum_j x_ij * (j % 97 + 1)) * (i % 13 + 1),
    leaves in named_parameters() (or mapping, or iteration) order."""
    if isinstance(params, nn.Module):
        leaves = [p for _, p in params.named_parameters()]
    elif isinstance(params, Mapping):
        leaves = list(params.values())
    else:
        leaves = list(params)
    total = None
    for i, leaf in enumerate(leaves):
        x = leaf.detach().float().reshape(-1)
        w = torch.arange(x.shape[0], dtype=torch.float32, device=x.device) % 97.0 + 1.0
        term = torch.sum(x * w) * ((i % 13) + 1)
        total = term if total is None else total + term
    return torch.zeros(()) if total is None else total

"""Attention op (port of loco_edit_tpu/ops/attention.py::sdp_attention).

ADM numerics: q and k are each pre-scaled by d^-1/4, the softmax is in
float32, the output is in the input dtype. The differentiation rule is the
JAX package's default, the lean JVP (ops/flash_attention.py).
"""

from __future__ import annotations

import torch
from torch.overrides import handle_torch_function, has_torch_function_variadic

from loco_edit_tpu_torch.ops.flash_attention import AttentionFn


def sdp_attention(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, H, N, D). Returns (B, H, N, D) in q.dtype; the kernel
    takes N_q != N_kv. Overridable by a TorchFunctionMode: spatial
    parallelism (parallel/sp.py) gathers every rank's keys and values
    before the call, so this rank's queries attend to the whole image."""
    if has_torch_function_variadic(q, k, v):
        return handle_torch_function(sdp_attention, (q, k, v), q, k, v)
    return AttentionFn.apply(q, k, v)

"""The yardstick's arithmetic: the floating-point operations an edit needs
(for `mfu`), the least time of a kernel launch (for the rooflines), and
the H100's peaks.

Counting rules:

- A model forward counts the operations of its convolutions, dense layers
  and attention products (2 per multiply-add) as `FlopCounterMode` counts
  them over the frozen reference model of reference/, on the meta device.
  Nothing the program does can change the count.
- A forward at batch B counts B times the batch-1 forward.
- A basis counts one primal forward (the algorithm needs one; the program
  may run more), and for each sweep and each probe one forward for the
  tangent pass (J v) and one for the cotangent pass (J^T u): those passes
  repeat the linear layers' products once each, and no weight gradient is
  needed. A cached basis counts nothing.
- Generation and strip forwards count at their batch.
- The least time of a launch is max(operations / peak, bytes / HBM
  bandwidth), where each input is read once and each output written once.
  GroupNorm: bytes 2 x the tensor + the f32 scale and shift, 8 operations
  an element on the f32 pipes outside the tensor cores. Attention: bytes
  q, k, v read and o written; operations 4 B H N_q N_kv D.

Peaks (NVIDIA's data sheet, H100 SXM, dense): 989e12 bf16 tensor-core
operations a second; 495e12 TF32, of which an f32-accurate product
(3xTF32, three products each) gets a third; 67e12 f32 outside the tensor
cores; 3.35e12 bytes a second of HBM3. A model's share of the peak (`mfu`)
is taken against the fastest rate its served dtype's products can reach:
989e12 for bfloat16, and for float32 (TF32 off) the TF32 tensor cores'
495e12, which no f32-accurate product exceeds.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 495e12 / 3, "float32_fma": 67e12}
MODEL_PEAK = {"bf16": 989e12, "fp32": 495e12}     # by the configuration's dtype


def forward_flops(model: torch.nn.Module, *inputs) -> int:
    """Operations of one forward of `model` on `inputs` (meta tensors for a
    model on the meta device), as FlopCounterMode counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(*inputs)
    return int(fc.get_total_flops())


def basis_flops(forward: float, sweeps: int, probes: int) -> float:
    """One primal, then per sweep and probe a tangent and a cotangent pass."""
    return forward * (1 + 2 * sweeps * probes)


def least_seconds(nbytes: float, flops: float, peak: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK[peak])


def groupnorm_least_s(shape, itemsize: int) -> float:
    """A GroupNorm launch over a (B, C, H, W) tensor of `itemsize` bytes."""
    b, c, h, w = shape
    n = b * c * h * w
    return least_seconds(2 * n * itemsize + 2 * c * 4, 8 * n, "float32_fma")


def attention_least_s(b, heads, nq, nkv, d, dtype: str) -> float:
    """An attention launch over (B, H, N, D) q and o and (B, H, N_kv, D) k, v."""
    itemsize = 2 if dtype == "bfloat16" else 4
    return least_seconds(2 * b * heads * (nq + nkv) * d * itemsize,
                         4 * b * heads * nq * nkv * d, dtype)

"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card present they raise; they never carry on silently on the CPU. The f32
entry points set the port's f32 policy (`use_full_f32`). Host values go to
the card through `to_device`.
"""

from __future__ import annotations

import torch

from loco_edit_tpu_torch.utils.logger import readback


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_full_f32(dtype: torch.dtype = torch.float32) -> None:
    """The port's f32 policy, set by its f32 entry points (the loaders at
    dtype float32, which the CLI's --dtype fp32 reaches, and SAM): cuBLAS
    matmuls and cuDNN convolutions in full f32, not TF32. PyTorch's default
    runs f32 convolutions in TF32, which moves a full-width f32 forward off
    the CPU by more than 1e-3 relative (PERF.md section 7). Process-wide, as
    the flags are; a bf16 dtype leaves them as they are."""
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def to_device(value, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """torch.as_tensor(value, dtype=dtype, device=device). A copy from host
    memory to a card waits for the card (PyTorch ends a copy from pageable
    memory with a stream synchronize), so it is a readback
    (utils/logger.py); a tensor already on a card, or a CPU target, is
    converted as it is."""
    on_card = isinstance(value, torch.Tensor) and value.device.type == "cuda"
    if on_card or torch.device(device).type != "cuda":
        return torch.as_tensor(value, dtype=dtype, device=device)
    with readback():
        return torch.as_tensor(value, dtype=dtype, device=device)

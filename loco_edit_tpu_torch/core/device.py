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
    dtype float32, which the CLI's --dtype fp32 and an f32 training run
    built on them reach, and SAM): cuBLAS matmuls and cuDNN convolutions in
    full f32, not TF32, each convolution on the faster of the first two
    engines cuDNN proposes for it, by measurement.

    TF32 convolutions move the full-width f32 FFHQ_P2 eps 8.7e-4 to
    9.8e-4 of its largest value off the CPU's on an H100, full f32 5.9e-6
    (tests/test_torch_cuda.py::test_f32_loader_sets_full_f32_policy holds
    a bound between them).

    cuDNN's heuristic alone sends batched f32 convolutions to FFT-tiling
    engines far slower than its second proposal: one P2 forward's
    convolutions at batch 9 take 1030 ms against 106 on an H100
    (docs/CONV_CHOICE_P2.md has each shape). `cudnn.benchmark` times the
    candidates the first time a thread runs a convolution signature
    (shapes, memory format, dtype, pass) and keeps the fastest for that
    thread. `benchmark_limit` 2 (PyTorch's default 10) bounds that
    one-time cost: about 8 s in the LCM engine's first edit against 180 s
    with 10, while one P2 forward's convolutions, forward and input
    gradient together, stay within 9 % of the 10-candidate choice's time
    at every batch (PERF.md section 6). The cost lands in the first call of
    each signature on a thread: the server's warm-up edit, made on the
    device thread that runs every request's device work (serve.py), a
    fixed-shape training run's first step; a caller that changes the
    image size on every request pays it once a size.

    Under these flags the models' float32 convolutions on the card (their
    `ops.Conv2d`, groups 1) of 25 GFLOP and more, with 8 channels or more
    in and out and a kernel wider than 1x1 (or 256 outputs or more), leave
    full-f32 cuDNN for an exact-f32 route on the TF32 tensor cores
    (ops/conv.py): each operand split into a TF32-rounded high part and its
    exact f32 remainder, the three products that carry f32 accuracy
    (hi*hi + hi*lo + lo*hi, short of lo*lo, 2^-22 of a product) as two TF32
    cuDNN convolutions summed in f32, hi*hi's depth cut into chunks of at
    most MAX_DEPTH products, each with its own accumulator, so that the
    tensor cores' truncated sums stay near f32's own rounding. The rule is
    one of shapes, read off measured tables (docs/CONV_3XTF32.md); smaller
    convolutions stay here (the route's host cost outweighs its saving).
    Only the route's calls allow TF32, through their own argument; the
    flags here stay as set.

    Process-wide, as the flags are; a bf16 dtype leaves all of them as
    they are."""
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.benchmark_limit = 2


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

"""The inputs the benchmark makes from --seed and hands to both the program
and the reference: model weights, prompt embeddings and the seeds of a
run's streams. Nothing here reads the program."""

from __future__ import annotations

import hashlib
import math

import torch

# streams of one run, by purpose: each a distinct seed drawn from --seed
_PURPOSES = ("weights", "server", "traffic", "sample", "prompts")


def served_dtype(config: dict) -> torch.dtype:
    """The dtype a configuration serves its model in ("fp32" or "bf16")."""
    return {"fp32": torch.float32, "bf16": torch.bfloat16}[config["dtype"]]


def sub_seed(seed: int, purpose: str) -> int:
    """A 62-bit seed for one purpose of the run seeded by `seed` (any
    integer, negative or above 2**32 included)."""
    if purpose not in _PURPOSES:
        raise ValueError(f"unknown seed purpose {purpose!r}")
    h = hashlib.blake2b(f"{int(seed)}/{purpose}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 2


def weight_specs(module: torch.nn.Module) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of each parameter, in registration order."""
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@torch.no_grad()
def make_weights(specs, seed: int, device, dtype: torch.dtype):
    """Seeded weights for the parameters `specs`, made on `device` in one
    normal draw of `dtype` (the type they are served in) and scaled per
    tensor: matrices and kernels to a variance of 1/fan_in, vector weights
    (norm scales) about 1, biases small. Yields (name, tensor in `dtype`): the same bits
    for the same seed, specs and device."""
    total = sum(math.prod(s) for _, s in specs)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    at = 0
    for name, shape in specs:
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            w = z * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith("weight"):   # a vector weight: a norm's scale
            w = 1.0 + 0.1 * z
        else:
            w = 0.02 * z
        yield name, w.to(dtype)


@torch.no_grad()
def load_weights(module: torch.nn.Module, seed: int, dtype: torch.dtype) -> None:
    """Fill every parameter of `module` with make_weights' tensors of
    `dtype` (the configuration's), each copied into the parameter's own
    dtype."""
    params = dict(module.named_parameters())
    dev = next(iter(params.values())).device
    for name, w in make_weights(weight_specs(module), seed, dev, dtype):
        params[name].copy_(w)


def prompt_embedding(seed: int, prompt: str, shape, device) -> torch.Tensor:
    """A prompt's (1, tokens, width) embedding: a normal draw seeded by the
    run's prompt seed and the prompt's text, in float32."""
    h = hashlib.blake2b(prompt.encode(), digest_size=8).digest()
    g = torch.Generator(device=device).manual_seed(
        (seed ^ int.from_bytes(h, "little")) >> 2)
    return torch.randn((1,) + tuple(shape), generator=g, device=device)

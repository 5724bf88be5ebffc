"""Shared checkpoint-conversion helpers (port of
loco_edit_tpu/models/convert_util.py, for torch state_dicts).

The JAX package converts every checkpoint into a Flax tree; the port's
modules carry the Flax names (`down_0_block_0.norm1`, `input_3.res_0.in_conv`)
in torch layouts, so two kinds of conversion meet here:

  - a flat Flax parameter dict (a `.npz` as the JAX package's
    `save_params_npz` writes it) to a state_dict: `flax_to_state_dict`;
  - a torch checkpoint in its own naming to the port's naming: the layouts
    already agree (Linear (O, I), Conv2d OIHW), so `copy_param` renames and
    only squeezes 1x1 convolutions used as Linear layers.

`check_state_dict` holds a converted dict to a model's module tree key for
key and shape for shape, so a geometry mismatch is an error, not a partial
load.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def to_tensor(a) -> torch.Tensor:
    """An f32 CPU tensor from a numpy array or a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def copy_param(sd: Mapping, src: str, out: dict, dst: str,
               as_linear: bool = False) -> None:
    """out[dst.weight], out[dst.bias] = sd[src.weight], sd[src.bias]; with
    as_linear a (O, I, 1, 1) conv or (O, I, 1) conv1d weight becomes (O, I)."""
    w = to_tensor(sd[f"{src}.weight"])
    if as_linear:
        w = w.reshape(w.shape[0], w.shape[1])
    out[f"{dst}.weight"] = w
    out[f"{dst}.bias"] = to_tensor(sd[f"{src}.bias"])


def flax_to_state_dict(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Carry a flat Flax parameter dict ("params/input_0/conv_0/kernel"
    style keys, the leading "params/" optional) to torch names and layouts.

    Dense kernels (in, out) become Linear weights (out, in); conv kernels
    HWIO become OIHW; GroupNorm `scale` and Embed `embedding` become
    `weight`; a raw `positional_embedding` (the IF attention pool's) keeps
    its name and layout."""
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        *mods, leaf = parts
        a = np.asarray(arr, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        elif leaf not in ("bias", "positional_embedding"):
            raise ValueError(f"unexpected Flax parameter {key!r}")
        sd[".".join(mods + [leaf])] = torch.tensor(a)
    return sd


def check_state_dict(sd: Mapping[str, torch.Tensor], model: nn.Module,
                     what: str) -> None:
    """Raise ValueError unless sd has exactly model's keys and shapes."""
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got != expected:
        missing = sorted(set(expected) - set(got))
        extra = sorted(set(got) - set(expected))
        shapes = sorted(k for k in set(got) & set(expected) if got[k] != expected[k])
        raise ValueError(f"{what} do not match the model: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}, shape "
                         f"mismatch {shapes[:5]}")


class KeyTracker:
    """Wraps a state_dict and records every key read, so a converter can
    require full coverage: a partial load (geometry mismatch, renamed keys)
    is an error, not random-looking outputs."""

    def __init__(self, sd: Mapping):
        self.sd = sd
        self.used: set[str] = set()

    def __getitem__(self, k):
        self.used.add(k)
        return self.sd[k]

    def __contains__(self, k):
        return k in self.sd

    def check(self, what: str) -> None:
        leftovers = sorted(set(self.sd) - self.used)
        if leftovers:
            raise ValueError(
                f"{what} conversion left {len(leftovers)} checkpoint keys "
                f"unconsumed (geometry mismatch?): {leftovers[:8]}...")

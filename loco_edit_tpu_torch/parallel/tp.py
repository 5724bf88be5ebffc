"""Tensor-parallel parameter sharding (port of loco_edit_tpu/parallel/tp.py).

Every large kernel is split along its output features over the `tp` mesh
axis as a DTensor `Shard`; biases and norm parameters stay replicated.

Layout: the JAX package shards the last dim of HWIO conv kernels and (I, O)
dense kernels, their output features. A torch Conv2d weight is
(O, I, kh, kw) and a Linear weight (O, I): the output features are dim 0
(an Embedding table keeps them last, as the JAX package's does). The rule (at least `min_size` elements, the output-feature dim divisible
by the axis size) is applied to that dim, so the same model shards the
same parameters, and `tp_fraction_sharded` equals the JAX package's.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from loco_edit_tpu_torch.core.mesh import Mesh

TP_AXIS = "tp"


def _is_sharded(p: torch.Tensor, dim: int, tp: int, min_size: int) -> bool:
    return p.dim() >= 2 and p.numel() >= min_size and p.shape[dim] % tp == 0


def _named_params(params) -> dict[str, tuple[torch.Tensor, int]]:
    """name -> (parameter, its output-feature dim): dim 0 of conv and dense
    weights, the last dim of an embedding table (the JAX package's `Embed`
    has the same layout); dim 0 for a plain mapping."""
    if not isinstance(params, nn.Module):
        return {k: (v, 0) for k, v in params.items()}
    out = {}
    for mname, mod in params.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            dim = p.dim() - 1 if isinstance(mod, nn.Embedding) else 0
            out[f"{mname}.{pname}" if mname else pname] = (p, dim)
    return out


def tp_param_shardings(params, mesh: Mesh, axis: str = TP_AXIS,
                       min_size: int = 1 << 16) -> dict[str, list]:
    """name -> DTensor placements over mesh's axes for a module's parameters
    (or a name -> tensor mapping): Shard(output-feature dim) on `axis` for
    kernels with >= min_size elements whose output features divide the axis
    size, Replicate() elsewhere."""
    tp = mesh.shape[axis]
    out = {}
    for name, (p, dim) in _named_params(params).items():
        sharded = _is_sharded(p, dim, tp, min_size)
        out[name] = [Shard(dim) if (a == axis and sharded) else Replicate()
                     for a in mesh.axis_names]
    return out


def shard_params_tp(params, mesh: Mesh, axis: str = TP_AXIS,
                    min_size: int = 1 << 16) -> dict:
    """name -> DTensor of each parameter laid out by tp_param_shardings
    (every rank passes the same replicated values)."""
    placements = tp_param_shardings(params, mesh, axis, min_size)
    return {name: distribute_tensor(p.detach(), mesh.device_mesh, placements[name])
            for name, (p, _) in _named_params(params).items()}


def tp_fraction_sharded(params, mesh: Mesh, axis: str = TP_AXIS,
                        min_size: int = 1 << 16) -> float:
    """Fraction of parameter elements that end up sharded."""
    tp = mesh.shape[axis]
    tot = shard = 0
    for p, dim in _named_params(params).values():
        tot += p.numel()
        if _is_sharded(p, dim, tp, min_size):
            shard += p.numel()
    return shard / max(tot, 1)

"""Spatial parallelism: the image height split over ranks (port of
loco_edit_tpu/parallel/sp.py).

The latency-bound paths of the workload (batch-1 DDIM inversion and
generation, the PMP pullback at batch 1) cannot use data parallelism, so
the rows of the image are split over the mesh. The JAX package annotates
the input's sharding and XLA inserts the collectives. Here `sp_denoiser`
gives each rank its band of rows and runs the model under `sp_context`,
where the port writes those collectives itself:

  - 3x3 convolutions (stride 1 and 2; `torch.conv2d`, and the models'
    `ops.conv2d`, which routes f32 ones on the card) and the DDPM
    downsample's asymmetric pad take halo rows from the neighbouring ranks
    (collectives.halo_pad) in place of zero padding in the height; the
    nearest upsample and the average pool are local;
  - GroupNorm (ops/norms.py) is given the group: it runs the kernel's
    statistics pass, all-reduces the sums and runs its normalize pass with
    the whole image's statistics;
  - attention (ops/attention.py) is given keys and values gathered from
    every rank, so the local queries attend to all tokens.

Every collective is differentiable under torch.func (collectives.py), so the
sharded denoiser goes through the Jacobian subspace iteration unchanged.
H must divide by the mesh size times the model's deepest downsampling.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from loco_edit_tpu_torch.core.mesh import Mesh, make_mesh, world_size
from loco_edit_tpu_torch.ops import conv2d, group_norm_f32, sdp_attention
from loco_edit_tpu_torch.parallel.collectives import (all_gather, gather_replicated,
                                                      halo_pad, take_shard)

SP_AXIS = "sp"


def make_sp_mesh(n_devices: int | None = None) -> Mesh:
    """A one-axis ("sp") mesh over every rank; make_mesh's ValueError when
    n_devices (default: the world size) is not the world size."""
    return make_mesh({SP_AXIS: world_size() if n_devices is None else n_devices})


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class _SPMode(TorchFunctionMode):
    """Rewrites the height padding of conv2d and of F.pad into halo rows,
    gives GroupNorm the group and attention every rank's keys and values."""

    def __init__(self, group):
        super().__init__()
        self.group = group

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.conv2d or func is conv2d:
            return self._conv2d(func, *args, **kwargs)
        if func is F.pad:
            return self._pad(*args, **kwargs)
        if func is group_norm_f32:
            return func(*args, **dict(kwargs, group=self.group))
        if func is sdp_attention:
            q, k, v = args
            return func(q, all_gather(k, 2, self.group), all_gather(v, 2, self.group))
        return func(*args, **kwargs)

    def _conv2d(self, conv, x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1):
        if isinstance(padding, str):
            raise NotImplementedError(f"spatial parallelism: conv2d padding={padding!r}")
        ph, pw = _pair(padding)
        if ph:
            x = halo_pad(x, ph, ph, self.group)
        return conv(x, weight, bias, stride, (0, pw), dilation, groups)

    def _pad(self, x, pad, mode="constant", value=None):
        if x.dim() == 4 and len(pad) >= 4 and (pad[2] or pad[3]):
            if mode != "constant" or value not in (None, 0, 0.0) or len(pad) > 4:
                raise NotImplementedError(
                    f"spatial parallelism: F.pad({tuple(pad)}, {mode!r}, {value})")
            x = halo_pad(x, pad[2], pad[3], self.group)
            pad = tuple(pad[:2])
            if not any(pad):
                return x
        return F.pad(x, pad, mode=mode, value=value)


@contextlib.contextmanager
def sp_context(mesh: Mesh):
    """Run the model code inside on this rank's band of rows of `mesh`'s
    one axis."""
    group = mesh.group(mesh.axis_names[0])
    if group is None:
        yield
        return
    with _SPMode(group):
        yield


def spatial_sharded(fn: Callable, mesh: Mesh) -> Callable:
    """Wrap a batched NHWC image fn (x, *args) -> NHWC so that each rank
    runs it on its band of x's rows (x replicated on every rank) and the
    result is gathered back, replicated. Composes with torch.func."""
    group = mesh.group(mesh.axis_names[0])

    def wrapped(x, *args, **kw):
        if group is None:
            return fn(x, *args, **kw)
        with sp_context(mesh):
            y = fn(take_shard(x, 1, group), *args, **kw)
        return gather_replicated(y, 1, group)

    return wrapped


def sp_denoiser(eps_fn: Callable, mesh: Mesh) -> Callable:
    """eps_fn(x, t) with the H axis split over `mesh`: a drop-in for
    Denoiser.eps_fn, so inversion, generation and the basis at batch 1 run
    across ranks."""
    return spatial_sharded(eps_fn, mesh)

"""Collectives as differentiable ops.

XLA inserts the collectives of a sharded JAX program and differentiates
through them. Here each one is a `torch.autograd.Function` with `jvp`,
`backward` and `vmap` rules, so the sharded model composes with
`torch.func.jvp`, `torch.func.vjp` and `torch.func.vmap` in the Jacobian
subspace iteration.

Every rank runs the same program (SPMD). A value is either replicated (the
same on every rank) or sharded (each rank holds its part). Inside a sharded
region a cotangent on a rank is that rank's share of the whole; the rules
follow from that:
  - all_reduce_sum: tangent and cotangent are all-reduced too;
  - all_gather (shards -> the whole, each rank using it for its own part,
    as attention uses the gathered keys): tangent gathered, cotangent
    all-reduced and sliced back (a reduce-scatter);
  - gather_replicated (shards -> the whole, used alike on every rank, as
    the output of a sharded model): tangent gathered, cotangent sliced;
  - take_shard (the whole -> this rank's part): tangent sliced, cotangent
    gathered;
  - halo_pad (neighbouring rows around a band of an image): tangent
    exchanged alike, the halo's cotangent sent back to its owner and added.

With group None (one rank) each is the identity, or zero padding for
halo_pad. The transport is chosen in one place (`_native`): the backend's
own all_gather and point-to-point sends (a halo goes only to the
neighbour), except for CUDA tensors over gloo, which moves those only by
all_reduce and broadcast. Ranks that share a card over gloo send a gather
as an all_reduce over a zero-filled (world x part) buffer, and a halo as
such a gather.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist


# The transport, outside autograd: for values no derivative flows through
# (probe images after a sweep, gathered strips, gradients, losses).

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's x (a new tensor)."""
    y = x.contiguous().clone()
    if group is not None:
        dist.all_reduce(y, group=group)
    return y


# torch >= 2.13 renames all_gather_into_tensor
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _native(x: torch.Tensor, group) -> bool:
    """Whether the backend moves x by its own all_gather and send/recv."""
    return not (x.is_cuda and dist.get_backend(group) == "gloo")


def gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(world, *x.shape): every rank's x, in rank order."""
    w = group_size(group)
    if w == 1:
        return x[None]
    x = x.contiguous()
    if _native(x, group):
        buf = x.new_empty((w * x.numel(),))
        _all_gather_single(buf, x.reshape(-1), group=group)
        return buf.reshape((w,) + tuple(x.shape))
    buf = x.new_zeros((w,) + tuple(x.shape))
    buf[group_rank(group)] = x
    dist.all_reduce(buf, group=group)
    return buf


def neighbour_rows(to_prev: torch.Tensor | None, to_next: torch.Tensor | None,
                   group) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(from_prev, from_next): the previous rank's to_next and the next
    rank's to_prev (None at the first / last rank, or where no rank sends
    that way). Every rank passes tensors of the same shapes, or None alike."""
    r, w = group_rank(group), group_size(group)
    like = to_prev if to_prev is not None else to_next
    if like is None or w == 1:
        return None, None
    if not _native(like, group):       # a gather of each direction's rows
        prev_rows = None if to_next is None else gather_stack(to_next, group)
        next_rows = None if to_prev is None else gather_stack(to_prev, group)
        return (None if prev_rows is None or r == 0 else prev_rows[r - 1],
                None if next_rows is None or r == w - 1 else next_rows[r + 1])
    peer = functools.partial(dist.get_global_rank, group)
    to_prev, to_next = (None if t is None else t.contiguous() for t in (to_prev, to_next))
    ops, from_prev, from_next = [], None, None
    if r > 0:
        if to_next is not None:
            from_prev = torch.empty_like(to_next)
            ops.append(dist.P2POp(dist.irecv, from_prev, peer(r - 1), group))
        if to_prev is not None:
            ops.append(dist.P2POp(dist.isend, to_prev, peer(r - 1), group))
    if r < w - 1:
        if to_prev is not None:
            from_next = torch.empty_like(to_prev)
            ops.append(dist.P2POp(dist.irecv, from_next, peer(r + 1), group))
        if to_next is not None:
            ops.append(dist.P2POp(dist.isend, to_next, peer(r + 1), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


def gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's x concatenated along dim, in rank order."""
    parts = gather_stack(x, group)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def own_part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal part of x along dim."""
    w = group_size(group)
    n = x.shape[dim] // w
    return x.narrow(dim, group_rank(group) * n, n).contiguous()


class AllReduceSum(torch.autograd.Function):
    generate_vmap_rule = False

    @staticmethod
    def forward(x, group):
        return reduce_sum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def jvp(ctx, dx, _):
        return AllReduceSum.apply(dx, ctx.group)

    @staticmethod
    def backward(ctx, g):
        return AllReduceSum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return AllReduceSum.apply(x, group), in_dims[0]


class AllGather(torch.autograd.Function):
    """Concatenate every rank's x along dim; cotangent reduce-scattered
    (replicated=False) or sliced (replicated=True)."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, dim, group, replicated):
        return gather_cat(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.dim, ctx.group, ctx.replicated = inputs

    @staticmethod
    def jvp(ctx, dx, *_):
        return AllGather.apply(dx, ctx.dim, ctx.group, ctx.replicated)

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated:
            g = AllReduceSum.apply(g, ctx.group)
        return TakeShard.apply(g, ctx.dim, ctx.group), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, group, replicated):
        x = x.movedim(in_dims[0], 0)
        return AllGather.apply(x, dim % (x.dim() - 1) + 1, group, replicated), 0


class TakeShard(torch.autograd.Function):
    """This rank's equal part of x along dim; cotangent gathered."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, dim, group):
        return own_part(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.dim, ctx.group = inputs

    @staticmethod
    def jvp(ctx, dx, *_):
        return TakeShard.apply(dx, ctx.dim, ctx.group)

    @staticmethod
    def backward(ctx, g):
        return AllGather.apply(g, ctx.dim, ctx.group, True), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        x = x.movedim(in_dims[0], 0)
        return TakeShard.apply(x, dim % (x.dim() - 1) + 1, group), 0


class HaloPad(torch.autograd.Function):
    """Extend a band of rows (dim -2 of (..., H, W)) by `top` rows of the
    previous rank and `bottom` rows of the next; zeros beyond the first and
    last rank, where the whole image has its border."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, top, bottom, group):
        h = x.shape[-2]
        if top > h or bottom > h:
            raise ValueError(f"halo of {max(top, bottom)} rows over a band of {h}")
        # my top halo is the previous rank's last rows, my bottom halo the
        # next rank's first rows
        above, below = neighbour_rows(x[..., :bottom, :] if bottom else None,
                                      x[..., h - top:, :] if top else None, group)
        edge_shape = list(x.shape)
        parts = []
        if top:
            edge_shape[-2] = top
            parts.append(above if above is not None else x.new_zeros(edge_shape))
        parts.append(x)
        if bottom:
            edge_shape[-2] = bottom
            parts.append(below if below is not None else x.new_zeros(edge_shape))
        return torch.cat(parts, dim=-2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.top, ctx.bottom, ctx.group = inputs

    @staticmethod
    def jvp(ctx, dx, *_):
        return HaloPad.apply(dx, ctx.top, ctx.bottom, ctx.group)

    @staticmethod
    def backward(ctx, g):
        return HaloUnpad.apply(g, ctx.top, ctx.bottom, ctx.group), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, top, bottom, group):
        return HaloPad.apply(x.movedim(in_dims[0], 0), top, bottom, group), 0


class HaloUnpad(torch.autograd.Function):
    """The transpose of HaloPad: drop the halo rows and add each one to the
    rows of the rank that owns it."""

    generate_vmap_rule = False

    @staticmethod
    def forward(g, top, bottom, group):
        h = g.shape[-2] - top - bottom
        out = g[..., top:top + h, :].clone()
        # my top halo goes back to the previous rank's last rows, my bottom
        # halo to the next rank's first rows
        from_prev, from_next = neighbour_rows(g[..., :top, :] if top else None,
                                              g[..., top + h:, :] if bottom else None,
                                              group)
        if from_next is not None:
            out[..., h - top:, :] += from_next
        if from_prev is not None:
            out[..., :bottom, :] += from_prev
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.top, ctx.bottom, ctx.group = inputs

    @staticmethod
    def jvp(ctx, dg, *_):
        return HaloUnpad.apply(dg, ctx.top, ctx.bottom, ctx.group)

    @staticmethod
    def backward(ctx, gg):
        return HaloPad.apply(gg, ctx.top, ctx.bottom, ctx.group), None, None, None

    @staticmethod
    def vmap(info, in_dims, g, top, bottom, group):
        return HaloUnpad.apply(g.movedim(in_dims[0], 0), top, bottom, group), 0


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Gather shards that each rank goes on to use for its own part."""
    return AllGather.apply(x, dim, group, False)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Gather shards into a value every rank then uses alike."""
    return AllGather.apply(x, dim, group, True)


def take_shard(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return TakeShard.apply(x, dim, group)


def halo_pad(x: torch.Tensor, top: int, bottom: int, group) -> torch.Tensor:
    return HaloPad.apply(x, top, bottom, group)

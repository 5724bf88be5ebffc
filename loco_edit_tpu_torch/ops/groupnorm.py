"""GroupNorm in f32 over channels: plain version, CUDA kernel, autograd rules.

Port of loco_edit_tpu/ops/norms.py::group_norm_f32 together with the Pallas
statistics kernel it can call (ops/pallas/groupnorm_stats.py). Tensors are
NCHW in `torch.channels_last` memory, so channels are contiguous, as they are
in the JAX package's NHWC arrays.

`GroupNormFn` is the one entry: the same autograd.Function runs on the CPU
and on the card, and only its innermost launch differs. On a CPU tensor the
forward is `group_norm_plain`; on a CUDA tensor it is the kernel in
csrc/groupnorm.cu, always. The forward-mode (`jvp`) and reverse-mode
(`backward`) rules are plain torch ops, which is what lets them run on
torch.func's batched tensors; they differentiate the plain formula exactly,
as JAX differentiates group_norm_f32. The `vmap` rule folds the vmapped
dimension into the batch and launches once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from loco_edit_tpu_torch.ops import _cuda
from loco_edit_tpu_torch.parallel.collectives import all_reduce_sum, group_size, reduce_sum

_THREADS = 256        # target threads per block of both launches
_UNROLL = 4           # 16-byte loads in flight per thread (kUnroll in the .cu)
_TARGET_BLOCKS = 2112     # 16 blocks per SM of a 132-SM H100: short chunks
_MIN_BLOCK_BYTES = 32768  # balance the tail; small tensors keep >= 32 KB a block
_MAX_THREADS_X = 512      # threads across C in one block row


class GNGeometry(NamedTuple):
    vec: int          # channels per 16-byte vector
    nvec: int         # vectors per thread: 1, or 2 above 512 vectors a pixel
    threads_x: int    # C / vec / nvec
    rows: int         # pixel rows per block step
    chunk: int        # pixels per block
    chunks: int       # blocks per batch element
    work: int         # f32 scratch: per-chunk group partials, mean and rstd


@functools.lru_cache(maxsize=1024)
def launch_geometry(b: int, c: int, hw: int, itemsize: int,
                    num_groups: int = 32) -> GNGeometry:
    """Launch geometry and scratch size of csrc/groupnorm.cu for a (B, C, H*W)
    input of `itemsize`-byte elements: blocks of (C / vec / nvec) x rows
    threads (nvec = 2 where one vector a thread would need more than
    _MAX_THREADS_X threads, f32 at C > 2048), each batch element cut into
    pixel chunks of whole unrolled steps, so that B * chunks comes near
    _TARGET_BLOCKS where every block still reads _MIN_BLOCK_BYTES."""
    vec = 16 // itemsize
    nvec = 1 if c // vec <= _MAX_THREADS_X else 2
    tx = c // vec // nvec
    rows = max(1, _THREADS // tx)
    step = rows * _UNROLL
    steps = -(-hw // step)
    per_b = min(steps, -(-_TARGET_BLOCKS // b),
                max(1, hw * c * itemsize // _MIN_BLOCK_BYTES))
    chunk = -(-steps // per_b) * step
    chunks = -(-hw // chunk)
    return GNGeometry(vec, nvec, tx, rows, chunk, chunks,
                      2 * b * chunks * num_groups + 2 * b * num_groups)


_scratch: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}


def _scratch_for(x: torch.Tensor, stream: int, b: int, work: int):
    """Pointers (tickets, work) for one launch on x's device and this stream.
    One buffer is kept per (device, stream) and made anew, larger, when a
    call needs more. Its first words are the kernel's int32 tickets, zeroed
    when the buffer is made and left at zero by every launch; launches on
    one stream run in order, so they share the rest as scratch."""
    key = (x.device.index, stream)
    buf, tickets = _scratch.get(key, (None, 0))
    if buf is None or tickets < b or buf.numel() < tickets + work:
        tickets = max(b, tickets, 64)
        buf = torch.zeros(tickets + 2 * work, dtype=torch.float32, device=x.device)
        _scratch[key] = buf, tickets
    return buf.data_ptr(), buf.data_ptr() + 4 * tickets


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _per_channel(t: torch.Tensor, cg: int) -> torch.Tensor:
    """(B, G) -> (B, 1, 1, C) broadcastable over NHWC."""
    return t.repeat_interleave(cg, dim=1)[:, None, None, :]


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """The plain PyTorch version: x (B, C, H, W), f32 statistics, output in
    x.dtype (the formula of loco_edit_tpu/ops/norms.py:59-78): the
    statistics pass and the normalize pass over x's own sums."""
    return group_norm_apply_plain(x, group_norm_sums_plain(x, num_groups),
                                  _world_count(x, num_groups, None), scale, bias,
                                  num_groups, eps)


def group_norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Launch csrc/groupnorm.cu. x: (B, C, H, W) channels_last, f32 or bf16,
    on a CUDA device; scale, bias: (C,) f32 on the same device."""
    geo = _check_cuda_input(x, num_groups, "group_norm_cuda", scale, bias)
    b, c, h, w = x.shape
    lib = _cuda.load_library()
    stream = _cuda.stream_of(x)
    tickets, work = _scratch_for(x, stream, b, geo.work)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    rc = lib.loco_group_norm(
        x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), work,
        tickets, b, h * w, c, num_groups, float(eps), geo.nvec, geo.rows, geo.chunk,
        int(x.dtype == torch.bfloat16), stream)
    _cuda.check(rc, "loco_group_norm")
    group_norm_cuda.launches += 1
    return y


group_norm_cuda.launches = 0


# -- the statistics and apply passes as entries of their own -----------------
#
# Spatial parallelism (parallel/sp.py) splits the image height over ranks:
# each rank sums its rows, the (2, B, G) sums are all-reduced, and each rank
# normalizes its rows with the statistics of the whole image. The fused
# entry would normalize each band with its own statistics.


def group_norm_sums_plain(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """(2, B, G) f32: per-(element, group) sums and sums of squares of x
    (B, C, H, W), summed per channel over the pixels first."""
    xf = _to_nhwc(x).float()
    b, c = xf.shape[0], xf.shape[-1]
    s = xf.sum(dim=(1, 2)).reshape(b, num_groups, c // num_groups).sum(-1)
    ss = (xf * xf).sum(dim=(1, 2)).reshape(b, num_groups, c // num_groups).sum(-1)
    return torch.stack([s, ss])


def _stats_from_sums(sums: torch.Tensor, n: float, eps: float):
    """mean, var (unclamped), rstd (B, G) from (2, B, G) sums of n elements
    a group: group_norm_f32's formula."""
    mean = sums[0] / n
    var = sums[1] / n - mean * mean
    return mean, var, torch.rsqrt(torch.clamp(var, min=0.0) + eps)


def group_norm_apply_plain(x: torch.Tensor, sums: torch.Tensor, n: float,
                           scale: torch.Tensor, bias: torch.Tensor,
                           num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Normalize x (B, C, H, W) with the statistics of (2, B, G) sums over n
    elements a group; output in x.dtype. With the sums of x itself and n its
    count this is group_norm_plain."""
    xf = _to_nhwc(x).float()
    cg = x.shape[1] // num_groups
    mean, _, rstd = _stats_from_sums(sums, n, eps)
    out = (xf - _per_channel(mean, cg)) * _per_channel(rstd, cg)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype).permute(0, 3, 1, 2)


def _check_cuda_input(x: torch.Tensor, num_groups: int, name: str,
                      scale: torch.Tensor | None = None,
                      bias: torch.Tensor | None = None) -> GNGeometry:
    """Raise unless the kernels take x (and scale, bias); their geometry."""
    if not x.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (B, C, H, W), got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if c % 32 or c % num_groups:
        raise ValueError(f"{name}: C={c} must divide by 32 and by {num_groups} groups")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be channels_last contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned "
                         "(the kernel moves 16-byte vectors)")
    for pname, p in (("scale", scale), ("bias", bias)):
        if p is not None and (p.dtype != torch.float32 or p.device != x.device
                              or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError(f"{name}: {pname} must be a contiguous ({c},) f32 "
                             f"tensor on {x.device}")
    geo = launch_geometry(b, c, h * w, x.element_size(), num_groups)
    if geo.threads_x > _MAX_THREADS_X or c % (geo.vec * geo.nvec):
        raise ValueError(f"{name}: C={c} too wide for one block row")
    return geo


def group_norm_sums_cuda(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """Launch the statistics pass of csrc/groupnorm.cu alone
    (loco_group_norm_sums): (2, B, G) f32 sums, reduced in the fused
    entry's fixed order."""
    geo = _check_cuda_input(x, num_groups, "group_norm_sums_cuda")
    b, c, h, w = x.shape
    lib = _cuda.load_library()
    stream = _cuda.stream_of(x)
    tickets, work = _scratch_for(x, stream, b, geo.work)
    sums = torch.empty((2, b, num_groups), dtype=torch.float32, device=x.device)
    rc = lib.loco_group_norm_sums(
        x.data_ptr(), sums.data_ptr(), work, tickets, b, h * w, c, num_groups,
        geo.nvec, geo.rows, geo.chunk, int(x.dtype == torch.bfloat16), stream)
    _cuda.check(rc, "loco_group_norm_sums")
    group_norm_sums_cuda.launches += 1
    return sums


group_norm_sums_cuda.launches = 0


def group_norm_apply_cuda(x: torch.Tensor, sums: torch.Tensor, n: float,
                          scale: torch.Tensor, bias: torch.Tensor,
                          num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Launch the normalize pass of csrc/groupnorm.cu alone
    (loco_group_norm_apply) from (2, B, G) f32 sums over n elements a
    group; mean and rstd are formed in the kernel with the fused entry's
    formula."""
    geo = _check_cuda_input(x, num_groups, "group_norm_apply_cuda", scale, bias)
    b, c, h, w = x.shape
    sums = sums.float().contiguous()
    if sums.shape != (2, b, num_groups) or sums.device != x.device:
        raise ValueError(f"group_norm_apply_cuda: sums must be (2, {b}, "
                         f"{num_groups}) on {x.device}")
    lib = _cuda.load_library()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    rc = lib.loco_group_norm_apply(
        x.data_ptr(), y.data_ptr(), sums.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), b, h * w, c, num_groups, float(n), float(eps), geo.nvec,
        geo.rows, geo.chunk, int(x.dtype == torch.bfloat16), _cuda.stream_of(x))
    _cuda.check(rc, "loco_group_norm_apply")
    group_norm_apply_cuda.launches += 1
    return y


group_norm_apply_cuda.launches = 0


def group_norm_sums(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """The statistics pass: the kernel on a CUDA tensor, the plain version
    on a CPU one."""
    if x.is_cuda:
        return group_norm_sums_cuda(_kernel_layout(x), num_groups)
    if x.device.type != "cpu":
        raise RuntimeError(f"group_norm_sums: no kernel for device {x.device}")
    return group_norm_sums_plain(x, num_groups)


def group_norm_apply(x: torch.Tensor, sums: torch.Tensor, n: float,
                     scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """The normalize pass: the kernel on a CUDA tensor, the plain version on
    a CPU one."""
    if x.is_cuda:
        return group_norm_apply_cuda(_kernel_layout(x), sums, n,
                                     scale.float().contiguous(),
                                     bias.float().contiguous(), num_groups, eps)
    if x.device.type != "cpu":
        raise RuntimeError(f"group_norm_apply: no kernel for device {x.device}")
    return group_norm_apply_plain(x, sums, n, scale, bias, num_groups, eps)


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels take it: channels_last and 16-byte aligned, copied
    when it is not (counted in GroupNormFn.layout_copies, so that a run can
    show how often a caller's layout costs a copy)."""
    if (not x.is_contiguous(memory_format=torch.channels_last)
            or x.data_ptr() % 16):
        GroupNormFn.layout_copies += 1
        x = x.clone(memory_format=torch.channels_last)
    return x


def _group_sums(t: torch.Tensor, num_groups: int, group) -> torch.Tensor:
    """(B, G) sums over pixels and the channels of each group of an NHWC f32
    t, all-reduced over `group` (when there is one)."""
    b, c = t.shape[0], t.shape[-1]
    s = t.sum(dim=(1, 2)).reshape(b, num_groups, c // num_groups).sum(-1)
    return s if group is None else all_reduce_sum(s, group)


def _world_count(x: torch.Tensor, num_groups: int, group) -> float:
    """Elements a group covers over every rank's band of x (B, C, H, W)."""
    return float(x.shape[2] * x.shape[3] * (x.shape[1] // num_groups) * group_size(group))


class GroupNormFn(torch.autograd.Function):
    """group_norm_f32 with hand-written jvp / backward / vmap rules.

    apply(x, scale, bias, num_groups, eps[, group]): with a process group
    (spatial parallelism, parallel/sp.py), x is this rank's band of rows
    and the statistics are the whole image's: the forward runs the
    statistics pass (group_norm_sums), all-reduces the (2, B, G) sums and
    runs the normalize pass (group_norm_apply) over every rank's element
    count, and every group reduction of the rules is all-reduced; the scale
    and bias cotangents are then this rank's share."""

    generate_vmap_rule = False
    layout_copies = 0     # CUDA inputs copied to channels_last / 16-byte alignment

    @staticmethod
    def forward(x, scale, bias, num_groups, eps, group=None):
        if x.device.type not in ("cuda", "cpu"):
            raise RuntimeError(f"GroupNormFn: no kernel for device {x.device}")
        if group is not None:
            sums = reduce_sum(group_norm_sums(x, num_groups), group)
            n = _world_count(x, num_groups, group)
            return group_norm_apply(x, sums, n, scale, bias, num_groups, eps)
        if x.is_cuda:
            return group_norm_cuda(_kernel_layout(x), scale.float().contiguous(),
                                   bias.float().contiguous(), num_groups, eps)
        return group_norm_plain(x, scale, bias, num_groups, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias, num_groups, eps, *group = inputs
        ctx.num_groups, ctx.eps = num_groups, eps
        ctx.group = group[0] if group else None
        ctx.n_inputs = len(inputs)
        ctx.save_for_backward(x, scale)
        ctx.save_for_forward(x, scale)

    @staticmethod
    def _stats(ctx, xf):
        """mean, var (unclamped), rstd (B, G) and the element count of a
        group, over every rank's rows."""
        g = ctx.num_groups
        n = _world_count(xf.permute(0, 3, 1, 2), g, ctx.group)
        sums = torch.stack([_group_sums(xf, g, ctx.group),
                            _group_sums(xf * xf, g, ctx.group)])
        return (*_stats_from_sums(sums, n, ctx.eps), n)

    @staticmethod
    def jvp(ctx, dx, dscale, dbias, *_):
        x, scale = ctx.saved_tensors
        g, cg, grp = ctx.num_groups, x.shape[1] // ctx.num_groups, ctx.group
        xf = _to_nhwc(x).float()
        mean, var, rstd, n = GroupNormFn._stats(ctx, xf)
        xc = xf - _per_channel(mean, cg)
        out = None
        if dx is not None:
            dxf = _to_nhwc(dx).float()
            dmean = _group_sums(dxf, g, grp) / n
            dvar = (_group_sums(2.0 * xf * dxf, g, grp) / n
                    - 2.0 * mean * dmean) * (var > 0)
            drstd = -0.5 * rstd ** 3 * dvar
            dxhat = ((dxf - _per_channel(dmean, cg)) * _per_channel(rstd, cg)
                     + xc * _per_channel(drstd, cg))
            out = dxhat * scale.float()
        if dscale is not None:
            term = xc * _per_channel(rstd, cg) * dscale.float()
            out = term if out is None else out + term
        if dbias is not None:
            term = dbias.float().expand(xf.shape)
            out = term if out is None else out + term
        if out is None:
            return None
        return out.to(x.dtype).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, gy):
        x, scale = ctx.saved_tensors
        g, cg, grp = ctx.num_groups, x.shape[1] // ctx.num_groups, ctx.group
        xf = _to_nhwc(x).float()
        mean, var, rstd, n = GroupNormFn._stats(ctx, xf)
        xc = xf - _per_channel(mean, cg)
        gyf = _to_nhwc(gy).float()
        gx = gscale = gbias = None
        if ctx.needs_input_grad[0]:
            a = gyf * scale.float()                                # dL/dxhat
            g_rstd = _group_sums(a * xc, g, grp)
            g_mean = -_group_sums(a, g, grp) * rstd
            g_var = g_rstd * (-0.5 * rstd ** 3) * (var > 0)
            g_s = (g_mean - 2.0 * mean * g_var) / n
            g_ss = g_var / n
            gxf = (a * _per_channel(rstd, cg) + _per_channel(g_s, cg)
                   + 2.0 * xf * _per_channel(g_ss, cg))
            gx = gxf.to(x.dtype).permute(0, 3, 1, 2)
        if ctx.needs_input_grad[1]:
            gscale = (gyf * xc * _per_channel(rstd, cg)).sum(dim=(0, 1, 2))
        if ctx.needs_input_grad[2]:
            gbias = gyf.sum(dim=(0, 1, 2))
        return (gx, gscale, gbias) + (None,) * (ctx.n_inputs - 3)

    @staticmethod
    def vmap(info, in_dims, x, scale, bias, num_groups, eps, *group):
        xd, sd, bd = in_dims[:3]
        if sd is not None or bd is not None:
            raise NotImplementedError("GroupNormFn.vmap: batched scale/bias")
        if xd is None:
            return GroupNormFn.apply(x, scale, bias, num_groups, eps, *group), None
        x = x.movedim(xd, 0)
        v, b = x.shape[:2]
        out = GroupNormFn.apply(x.reshape(v * b, *x.shape[2:]), scale, bias,
                                num_groups, eps, *group)
        return out.reshape(v, b, *out.shape[1:]), 0

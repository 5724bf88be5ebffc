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


def _group_stats(xf: torch.Tensor, num_groups: int, eps: float):
    """xf: (B, H, W, C) f32 view. Returns mean, var (unclamped), rstd as
    (B, G) f32, with group_norm_f32's formula."""
    b, c = xf.shape[0], xf.shape[-1]
    cg = c // num_groups
    n = xf.shape[1] * xf.shape[2] * cg
    s = xf.sum(dim=(1, 2))                             # (B, C)
    ss = (xf * xf).sum(dim=(1, 2))
    sg = s.reshape(b, num_groups, cg).sum(-1)          # (B, G)
    ssg = ss.reshape(b, num_groups, cg).sum(-1)
    mean = sg / n
    var = ssg / n - mean * mean
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return mean, var, rstd, n


def _per_channel(t: torch.Tensor, cg: int) -> torch.Tensor:
    """(B, G) -> (B, 1, 1, C) broadcastable over NHWC."""
    return t.repeat_interleave(cg, dim=1)[:, None, None, :]


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """The plain PyTorch version: x (B, C, H, W), f32 statistics, output in
    x.dtype (the formula of loco_edit_tpu/ops/norms.py:59-78)."""
    xf = _to_nhwc(x).float()
    cg = x.shape[1] // num_groups
    mean, _, rstd, _ = _group_stats(xf, num_groups, eps)
    out = (xf - _per_channel(mean, cg)) * _per_channel(rstd, cg)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype).permute(0, 3, 1, 2)


def group_norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Launch csrc/groupnorm.cu. x: (B, C, H, W) channels_last, f32 or bf16,
    on a CUDA device; scale, bias: (C,) f32 on the same device."""
    if not x.is_cuda:
        raise ValueError("group_norm_cuda takes CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm_cuda: dtype {x.dtype} not supported")
    if x.dim() != 4:
        raise ValueError(f"group_norm_cuda: expected (B, C, H, W), got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if c % 32 or c % num_groups:
        raise ValueError(f"group_norm_cuda: C={c} must divide by 32 and by "
                         f"{num_groups} groups")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("group_norm_cuda: x must be channels_last contiguous")
    for name, p in (("scale", scale), ("bias", bias)):
        if (p.dtype != torch.float32 or p.device != x.device
                or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError(f"group_norm_cuda: {name} must be a contiguous "
                             f"({c},) f32 tensor on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("group_norm_cuda: x must be 16-byte aligned "
                         "(the kernel moves 16-byte vectors)")
    geo = launch_geometry(b, c, h * w, x.element_size(), num_groups)
    if geo.threads_x > _MAX_THREADS_X or c % (geo.vec * geo.nvec):
        raise ValueError(f"group_norm_cuda: C={c} too wide for one block row")
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


class GroupNormFn(torch.autograd.Function):
    """group_norm_f32 with hand-written jvp / backward / vmap rules."""

    generate_vmap_rule = False
    layout_copies = 0     # CUDA inputs copied to channels_last / 16-byte alignment

    @staticmethod
    def forward(x, scale, bias, num_groups, eps):
        if x.is_cuda:
            if (not x.is_contiguous(memory_format=torch.channels_last)
                    or x.data_ptr() % 16):
                # counted, so a run can show how often a caller's layout costs a copy
                GroupNormFn.layout_copies += 1
                x = x.clone(memory_format=torch.channels_last)
            return group_norm_cuda(x, scale.float().contiguous(),
                                   bias.float().contiguous(), num_groups, eps)
        if x.device.type != "cpu":
            raise RuntimeError(f"GroupNormFn: no kernel for device {x.device}")
        return group_norm_plain(x, scale, bias, num_groups, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias, num_groups, eps = inputs
        ctx.num_groups = num_groups
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        ctx.save_for_forward(x, scale)

    @staticmethod
    def jvp(ctx, dx, dscale, dbias, _g, _e):
        x, scale = ctx.saved_tensors
        g, cg = ctx.num_groups, x.shape[1] // ctx.num_groups
        xf = _to_nhwc(x).float()
        mean, var, rstd, n = _group_stats(xf, g, ctx.eps)
        xc = xf - _per_channel(mean, cg)
        out = None
        if dx is not None:
            dxf = _to_nhwc(dx).float()
            b = x.shape[0]
            ds = dxf.sum(dim=(1, 2)).reshape(b, g, cg).sum(-1)
            dss = (2.0 * xf * dxf).sum(dim=(1, 2)).reshape(b, g, cg).sum(-1)
            dmean = ds / n
            dvar = (dss / n - 2.0 * mean * dmean) * (var > 0)
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
        g, cg = ctx.num_groups, x.shape[1] // ctx.num_groups
        b = x.shape[0]
        xf = _to_nhwc(x).float()
        mean, var, rstd, n = _group_stats(xf, g, ctx.eps)
        xc = xf - _per_channel(mean, cg)
        gyf = _to_nhwc(gy).float()
        gx = gscale = gbias = None
        if ctx.needs_input_grad[0]:
            a = gyf * scale.float()                                # dL/dxhat
            g_rstd = (a * xc).sum(dim=(1, 2)).reshape(b, g, cg).sum(-1)
            g_mean = -(a.sum(dim=(1, 2)).reshape(b, g, cg).sum(-1)) * rstd
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
        return gx, gscale, gbias, None, None

    @staticmethod
    def vmap(info, in_dims, x, scale, bias, num_groups, eps):
        xd, sd, bd = in_dims[:3]
        if sd is not None or bd is not None:
            raise NotImplementedError("GroupNormFn.vmap: batched scale/bias")
        if xd is None:
            return GroupNormFn.apply(x, scale, bias, num_groups, eps), None
        x = x.movedim(xd, 0)
        v, b = x.shape[:2]
        out = GroupNormFn.apply(x.reshape(v * b, *x.shape[2:]), scale, bias,
                                num_groups, eps)
        return out.reshape(v, b, *out.shape[1:]), 0

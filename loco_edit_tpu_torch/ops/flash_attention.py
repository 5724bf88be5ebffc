"""Attention with the ADM double-sqrt scale: plain version, CUDA kernel,
autograd rules.

Port of loco_edit_tpu/ops/pallas/flash_attention.py (the Pallas kernel) and
of the numerics it is held to, ops/attention.py::_xla_attention and the lean
JVP rule `_lean_attention_jvp` (attention.py:75-125).

`AttentionFn` is the one entry. Its forward is `attention_plain` on CPU
tensors and the kernel in csrc/flash_attention.cu on CUDA tensors, always.
Queries and keys may differ in number (N_q, N_kv: the SD cross-attention).
Its `jvp` is the lean rule: logits-sized tangents stay in the model dtype and
dW @ V is formed as t @ V - c * out, so dW is never built; out is W @ V of
the rule's own W, as in the JAX rule, not the kernel's output (whose
rounding differs from W's, by up to ~1e-6 on the 3xTF32 route). Its
`backward` is that rule's transpose, which is what `jax.linear_transpose`
derives in the JAX package. Both are plain torch ops, so they run on
torch.func's batched tensors. The `vmap` rule folds the vmapped dimension
into the batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from loco_edit_tpu_torch.ops import _cuda

# 40, 80 and 160 are the SD 1.5 / LCM U-Net's 8-head splits of 320, 640, 1280
HEAD_DIMS = (16, 32, 40, 64, 80, 128, 160, 256, 512)
SLICE = 128          # most output columns per block of the bf16 route (wider D is cut)


class AttnGeometry(NamedTuple):
    """csrc/flash_attention.cu's bf16 tiling of head dim d (its `tc::Geo<D>`)."""
    slices: int       # blocks across the output columns, one slice each
    dv: int           # output columns per slice: d / slices, at most SLICE
    kd: int           # depth of Q K^T on the bf16 route: d rounded up to 16
    block_k: int      # keys per shared-memory tile


class F32Geometry(NamedTuple):
    """csrc/flash_attention.cu's f32 (3xTF32) tiling of head dim d (its
    `tf32x3::Rows<D>` for d <= F32_ROWS_MAX_D, `tf32x3::Cols<D>` above)."""
    warps: int        # warps per block
    block_q: int      # query rows per block
    block_k: int      # keys per shared-memory tile
    cols: int         # output columns (and depth of the partial Q K^T) per warp


F32_ROWS_MAX_D = 80  # up to here each warp owns 16 query rows and all d columns


def kernel_geometry(d: int, dtype: torch.dtype = torch.bfloat16):
    """The tiling the kernel uses at head dim d. bf16 (AttnGeometry): equal
    output slices of at most SLICE columns (160 = 2 x 80), a zero-padded
    last 16-deep k-step where d is not a multiple of 16 (40 -> 48), 32-key
    tiles above SLICE. f32 (F32Geometry): up to F32_ROWS_MAX_D, 4 warps of
    16 query rows each over 32-key tiles (16 at d = 80); above, 32-row query
    tiles and 16-key tiles, S formed once by 8 warps (d / 32 below 256)
    that each take d / warps of the depth and of the output columns."""
    if dtype == torch.float32:
        if d <= F32_ROWS_MAX_D:
            return F32Geometry(4, 64, 32 if d <= 64 else 16, d)
        warps = 8 if d >= 256 else d // 32
        return F32Geometry(warps, 32, 16, d // warps)
    slices = -(-d // SLICE)
    return AttnGeometry(slices, d // slices, -(-d // 16) * 16, 32 if d > SLICE else 64)


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(math.sqrt(d))


def _weights(q: torch.Tensor, k: torch.Tensor):
    """Scaled q, k (input dtype) and the softmax weights in the input dtype."""
    scale = _scale(q.shape[-1])
    qs = q * scale
    ks = k * scale
    logits = torch.matmul(qs.float(), ks.float().transpose(-1, -2))
    return qs, ks, torch.softmax(logits, dim=-1).to(q.dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of _xla_attention: q (B, H, N_q, D), k, v
    (B, H, N_kv, D); f32 logits and softmax, weights and output in the
    input dtype."""
    _, _, w = _weights(q, k)
    return torch.matmul(w, v)


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel route a dtype and head dim take, both on the tensor cores.
    bf16: a head dim above SLICE is cut into output-column slices, one block
    each, and one that is not a multiple of 16 takes a zero-padded last
    k-step. f32: 3xTF32, every product split into TF32 hi and lo parts
    (rounded to nearest) and run as three MMAs, which keeps f32 accuracy
    where one TF32 rounding (2^-11) would not; above F32_ROWS_MAX_D the
    warps split the depth and the output columns (`-<warps>x<cols>-cols`),
    and S is formed once per tile."""
    if dtype == torch.float32:
        geo = kernel_geometry(d, dtype)
        return ("f32-3xtf32" if geo.cols == d
                else f"f32-3xtf32-{geo.warps}x{geo.cols}-cols")
    geo = kernel_geometry(d)
    name = "bf16-tensor-core" + (f"-k{geo.kd}" if geo.kd != d else "")
    return name if geo.slices == 1 else f"{name}-{geo.slices}x{geo.dv}-slices"


def _kernel_layout(t: torch.Tensor) -> bool:
    """Whether the kernel takes t's layout as it is: head dim of stride 1 and,
    on the bf16 route's 16-byte copies, a 16-byte aligned pointer and
    (b, h, n) strides that are multiples of 8 elements (the f32 route takes
    4-byte copies where a view is not 16-byte aligned)."""
    st = t.stride()
    return st[-1] == 1 and (t.dtype is not torch.bfloat16 or (
        t.data_ptr() % 16 == 0 and st[0] % 8 == 0 and st[1] % 8 == 0
        and st[2] % 8 == 0))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Launch csrc/flash_attention.cu. q: (B, H, N_q, D), k, v: (B, H, N_kv,
    D) CUDA tensors of one dtype (f32: the 3xTF32 route, or bf16), head dim
    of stride 1 (bf16: 16-byte aligned, strides multiples of 8), D in
    HEAD_DIMS, any N_q and N_kv >= 1. Returns a contiguous (B, H, N_q, D)
    tensor."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_cuda: dtype {q.dtype} not supported")
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]
            or min(q.shape[2], k.shape[2]) < 1):
        raise ValueError(f"flash_attention_cuda: q (B, H, N_q, D) and k, v "
                         f"(B, H, N_kv, D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for t in (q, k, v):
        if not t.is_cuda:
            raise ValueError("flash_attention_cuda takes CUDA tensors")
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError("flash_attention_cuda: q, k, v dtype/device differ")
        if not _kernel_layout(t):
            raise ValueError("flash_attention_cuda: head dim must have stride 1 "
                             "(bf16: 16-byte aligned, strides multiples of 8)")
    b, h, n, d = q.shape
    n_kv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in {HEAD_DIMS}")
    lib = _cuda.load_library()
    o = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    rc = lib.loco_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, n, n_kv, d,
        *strides, _scale(d), int(q.dtype == torch.bfloat16),
        _cuda.stream_of(q))
    _cuda.check(rc, "loco_flash_attention")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


class AttentionFn(torch.autograd.Function):
    """sdp attention with the lean jvp, its transpose and a vmap rule."""

    generate_vmap_rule = False
    layout_copies = 0     # CUDA inputs copied to a layout the kernel takes

    @staticmethod
    def forward(q, k, v):
        if q.is_cuda:
            args = []
            for t in (q, k, v):
                if not _kernel_layout(t):
                    AttentionFn.layout_copies += 1
                    t = t.clone(memory_format=torch.contiguous_format)
                args.append(t)
            return flash_attention_cuda(*args)
        if q.device.type != "cpu":
            raise RuntimeError(f"AttentionFn: no kernel for device {q.device}")
        return attention_plain(q, k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v = inputs
        ctx.save_for_backward(q, k, v)
        ctx.save_for_forward(q, k, v)

    @staticmethod
    def jvp(ctx, dq, dk, dv):
        q, k, v = ctx.saved_tensors
        scale = _scale(q.shape[-1])
        qs, ks, w = _weights(q, k)
        dout = None
        if dq is not None or dk is not None:
            dl = None
            if dq is not None:
                dl = torch.matmul(dq * scale, ks.transpose(-1, -2))
            if dk is not None:
                term = torch.matmul(qs, (dk * scale).transpose(-1, -2))
                dl = term if dl is None else dl + term
            t = w * dl.to(q.dtype)
            c = t.float().sum(dim=-1, keepdim=True)
            dout = torch.matmul(t, v) - c.to(q.dtype) * torch.matmul(w, v)
        if dv is not None:
            term = torch.matmul(w, dv)
            dout = term if dout is None else dout + term
        return dout

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale = _scale(q.shape[-1])
        qs, ks, w = _weights(q, k)
        g = g.to(q.dtype)
        gq = gk = gv = None
        if ctx.needs_input_grad[2]:
            gv = torch.matmul(w.transpose(-1, -2), g)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            # dout = t @ v - c * out, t = w * dl, c = rowsum(t), out = w @ v
            out = torch.matmul(w, v)
            gc = -(g.float() * out.float()).sum(dim=-1, keepdim=True)
            gt = torch.matmul(g, v.transpose(-1, -2)) + gc.to(q.dtype)
            gdl = w * gt
            if ctx.needs_input_grad[0]:
                gq = torch.matmul(gdl, ks) * scale
            if ctx.needs_input_grad[1]:
                gk = torch.matmul(gdl.transpose(-1, -2), qs) * scale
        return gq, gk, gv

    @staticmethod
    def vmap(info, in_dims, q, k, v):
        # an unbatched input (the cross-attention's k and v, made from the
        # context, carry no probe dimension) is expanded over the vmapped dim
        if all(d is None for d in in_dims):
            return AttentionFn.apply(q, k, v), None
        size = info.batch_size
        args = []
        for t, d in zip((q, k, v), in_dims):
            t = t.expand(size, *t.shape) if d is None else t.movedim(d, 0)
            args.append(t.reshape(size * t.shape[1], *t.shape[2:]))
        out = AttentionFn.apply(*args)
        return out.reshape(size, -1, *out.shape[1:]), 0

"""Exact-f32 convolutions on the TF32 tensor cores (3xTF32).

At float32 the port turns TF32 off (core/device.py::use_full_f32), so cuDNN
runs its convolutions on the f32 FMA pipes (67e12 on an H100) or by FFT
tiling. This module adds an f32-accurate route on the TF32 tensor cores
(495e12). Each operand v is split as hi = v rounded to TF32 (10 mantissa
bits, to nearest) and lo = v - hi (exact in f32), and

    conv(x, w) ~ conv(hi_x, hi_w) + conv([hi_x, lo_x], [lo_w, hi_w]),

the second a convolution with the depth doubled (hi_x * lo_w + lo_x * hi_w),
short of lo_x * lo_w (2^-22 of a product): the scheme of the f32 attention
kernel (csrc/flash_attention.cu). csrc/conv_split.cu writes an
activation's hi and pair in one pass, channels_last; a weight's parts are
made once per parameter version and kept (`_weight_parts`). The input
gradient is the same transposed: conv_T(hi_g, hi_w) + conv_T([hi_g, lo_g],
[lo_w; hi_w]), the weight's pair along its output channels.

The tensor cores add each k-step's products into their accumulator with
truncation, an error that grows with the number of products summed (on an
H100 about 2.4e-9 of the output's root mean square a product; f32 FMA
sums, rounded to nearest, grow as the square root). So hi*hi, the large
term, is summed over at most MAX_DEPTH products an accumulator: its depth
(channels x taps) is cut into `chunks` runs of channels, one TF32
convolution each (the split kernel writes each run as a tensor of its
own), added in f32 (docs/CONV_3XTF32.md; cuDNN's grouped convolutions ran
the same chunks up to 3 times slower). The small terms, 2^-11 of it, share
one accumulator. Only these calls run with TF32 allowed, through
`torch._convolution`'s own flag; the process-wide flags stay as the policy
set them, and the route's TF32 convolutions take cuDNN's heuristic engine
unmeasured (measuring them costs 50 to 650 ms a signature).

Which convolutions take the route is a rule of their shapes, read off the
measured tables of docs/CONV_3XTF32.md (`takes_route`): float32 on the card
under the f32 policy (cuDNN TF32 off), groups 1 and explicit padding,
MIN_CHANNELS channels in and out or more, MIN_FLOP operations or more as
the caller sees the shapes, and a kernel wider than 1x1 or, for a 1x1
convolution, MIN_1X1_OUT output channels or more. Anything else, bf16, the
CPU, TF32 turned on, or a smaller convolution, is `F.conv2d` as it was.

`conv2d` is the entry and `Conv2d` the module the models build. `ConvFn`
holds the differentiation rules: the tangent of the input goes through the
route, that of a weight only when there is one; the input gradient is
`ConvInputGradFn`, the weight gradient cuDNN's full-f32 one; the `vmap`
rules fold the vmapped dimension into the batch. On the CPU the Function
runs the route's arithmetic with plain convolutions (`split_plain`).

Each f32 convolution that `conv2d` is handed on the card adds its
operations, in GFLOP as the caller sees its shapes (under vmap a probe's
share), to the program's `conv_gflop` counter (utils/logger.py::count),
and a routed one to `conv_tc_gflop` as well: once a call, whatever passes
(tangent, input gradient) follow it on either route.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function_variadic
from torch.utils.weak import WeakIdKeyDictionary

from loco_edit_tpu_torch.ops import _cuda
from loco_edit_tpu_torch.utils.logger import count

# A TF32 k-step is 8 deep: with fewer channels in or out (an image's 3, a
# latent's 4) cuDNN pads them and builds a kernel at the first call, 1.5 to
# 2.2 s on an H100, where the route could win a few ms an edit
MIN_CHANNELS = 8
# The route costs host time, which a host-bound phase pays in full: on an
# H100's host ~0.15 ms a call outside torch.func and ~1.4 ms under its
# transforms (the autograd.Function machinery), where it saves ~0.019 ms a
# GFLOP of the device's. Below this size, as the caller sees it, a
# convolution stays with PyTorch (docs/CONV_3XTF32.md).
MIN_FLOP = 25e9
# A 1x1 convolution does 2 c_out operations a value the split moves (20
# bytes): with 128 outputs the f32 engines were faster on an H100, from 256
# the route (docs/CONV_3XTF32.md)
MIN_1X1_OUT = 256
# Most products one tensor-core accumulator sums in hi*hi: 1152 (128
# channels of a 3x3) holds the route near 2.7e-6 of the output's root mean
# square, 1 to 4.5 times the f32 engines' error on the cells' convolutions;
# LCM's basis_gap read 25 times the f32 engines' at 2304 and 6.5 times at
# 1152 (docs/CONV_3XTF32.md)
MAX_DEPTH = 1152


def tf32_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an f32 tensor: hi = v rounded to TF32's 10 mantissa bits,
    to nearest with ties away from zero (cvt.rna.tf32.f32), lo = v - hi,
    exact in f32."""
    bits = (v.view(torch.int32) + 0x1000) & -0x2000
    hi = bits.view(torch.float32)
    return hi, v - hi


def split_plain(t: torch.Tensor, dim: int = 1, lo_first: bool = False):
    """(hi, pair) of t: hi, and [hi, lo] (or [lo, hi] where lo_first) along
    `dim`. An activation's is the plain version of csrc/conv_split.cu."""
    hi, lo = tf32_split(t)
    return hi, torch.cat([lo, hi] if lo_first else [hi, lo], dim=dim)


def split_cuda(t: torch.Tensor, chunks: int = 1):
    """Launch csrc/conv_split.cu on an activation t (N, C, H, W): (hi cut
    into `chunks` equal runs of its channels, [hi, lo] along the channels)
    as `split` gives them, each a channels_last tensor (t is made
    channels_last first, a copy where it is not)."""
    if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 4:
        raise ValueError(f"split_cuda takes a 4-d f32 CUDA tensor, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    fmt = torch.channels_last
    t = t.contiguous(memory_format=fmt)
    n, c, h, w = t.shape
    if c % chunks:
        raise ValueError(f"split_cuda: {chunks} chunks of {c} channels")
    width = c // chunks
    pair = torch.empty((n, 2 * c, h, w), dtype=t.dtype, device=t.device, memory_format=fmt)
    flat = torch.empty(t.numel(), dtype=t.dtype, device=t.device)
    rc = _cuda.load_library().loco_conv_split(
        t.data_ptr(), flat.data_ptr(), pair.data_ptr(), t.numel(), c, width,
        _cuda.stream_of(t))
    _cuda.check(rc, "loco_conv_split")
    split_cuda.launches += 1
    his = [part.view(n, h, w, width).permute(0, 3, 1, 2) for part in flat.chunk(chunks)]
    return his, pair


split_cuda.launches = 0


def split(t: torch.Tensor, chunks: int = 1):
    """An activation's (hi in `chunks` runs of its channels, pair): the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if t.is_cuda:
        return split_cuda(t, chunks)
    hi, pair = split_plain(t)
    return list(hi.chunk(chunks, dim=1)), pair


def chunks(channels: int, taps: int) -> int:
    """How many accumulators hi*hi's depth (channels x taps products) is
    cut into: the fewest that divide the channels and hold at most
    MAX_DEPTH products each (one channel's taps where that is more)."""
    c = min(max(1, -(-channels * taps // MAX_DEPTH)), channels)
    while channels % c:
        c += 1
    return c


# A parameter's parts, kept with its _version and dropped with it, by the
# pass (1: the forward, its pair doubled along the input channels; 0: the
# input gradient, along the output channels) and the number of chunks.
_W_PARTS = WeakIdKeyDictionary()


def _weight_parts(w: torch.Tensor, dim: int, c: int) -> tuple[list, torch.Tensor]:
    """(hi_w in c runs along dim, the pair [lo_w, hi_w] along dim), each
    channels_last: a chunk of the forward's input channels, or of the input
    gradient's output channels, meets the activation's chunk of the same
    channels."""
    keep = isinstance(w, nn.Parameter)
    version, parts = _W_PARTS.get(w, (None, {})) if keep else (None, {})
    if version != w._version:
        parts = {}
    if (dim, c) not in parts:
        fmt = torch.channels_last
        hi, pair = split_plain(w.detach(), dim, lo_first=True)
        parts[(dim, c)] = ([h.contiguous(memory_format=fmt) for h in hi.chunk(c, dim=dim)],
                           pair.contiguous(memory_format=fmt))
        if keep:
            _W_PARTS[w] = (w._version, parts)
    return parts[(dim, c)]


class Geometry(NamedTuple):
    stride: tuple[int, int]
    padding: tuple[int, int]
    dilation: tuple[int, int]


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv(x, w, b, geo: Geometry, transposed: bool = False,
          output_padding=(0, 0)) -> torch.Tensor:
    """aten's TF32 convolution under the process's other cuDNN flags, on
    cuDNN's heuristic engine, unmeasured."""
    flags = torch.backends.cudnn
    return torch._convolution(
        x, w, b, geo.stride, geo.padding, geo.dilation, transposed, output_padding, 1,
        False, flags.deterministic or torch.are_deterministic_algorithms_enabled(),
        flags.enabled, True)


def conv_forward(x, w, b, geo: Geometry) -> torch.Tensor:
    """conv2d(x, w, b) on the 3xTF32 route (on the CPU, the route's
    arithmetic with plain convolutions): the small terms, then hi*hi chunk
    by chunk, added in f32."""
    c = chunks(w.shape[1], w.shape[2] * w.shape[3])
    (his, pair), (his_w, pair_w) = split(x, c), _weight_parts(w, 1, c)
    y = _conv(pair, pair_w, b, geo)
    for hi, hi_w in zip(his, his_w):
        y.add_(_conv(hi, hi_w, None, geo))
    return y


def conv_input_grad(gy, w, geo: Geometry, in_hw: tuple[int, int]) -> torch.Tensor:
    """The gradient of conv2d(x, w) with respect to x of height and width
    in_hw, from the output gradient gy: the transposed convolution, on the
    3xTF32 route, hi*hi in chunks of gy's channels."""
    out_hw = gy.shape[-2:]
    pad = tuple(in_hw[i] - ((out_hw[i] - 1) * geo.stride[i] - 2 * geo.padding[i]
                            + geo.dilation[i] * (w.shape[2 + i] - 1) + 1)
                for i in range(2))
    c = chunks(w.shape[0], w.shape[2] * w.shape[3])
    (his, pair), (his_w, pair_w) = split(gy, c), _weight_parts(w, 0, c)
    y = _conv(pair, pair_w, None, geo, True, pad)
    for hi, hi_w in zip(his, his_w):
        y.add_(_conv(hi, hi_w, None, geo, True, pad))
    return y


def _fold(t: torch.Tensor, dim: int) -> torch.Tensor:
    t = t.movedim(dim, 0)
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


class ConvFn(torch.autograd.Function):
    """conv2d(x, w, b) of geometry `geo` (groups 1) on the route of
    `conv_forward`, with jvp / backward / vmap rules."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, w, b, geo):
        return conv_forward(x, w, b, geo)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _, geo = inputs
        ctx.geo, ctx.out_shape = geo, output.shape
        ctx.set_materialize_grads(False)    # absent tangents come as None, not zeros
        ctx.save_for_backward(x, w)
        ctx.save_for_forward(x, w)

    @staticmethod
    def jvp(ctx, dx, dw, db, _):
        x, w = ctx.saved_tensors
        out = None if dx is None else ConvFn.apply(dx, w, None, ctx.geo)
        if dw is not None:
            term = ConvFn.apply(x, dw, None, ctx.geo)
            out = term if out is None else out + term
        if db is not None:
            term = db[:, None, None]
            out = term.expand(ctx.out_shape) if out is None else out + term
        return out

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        if gy is None:
            return gx, gw, gb, None
        if ctx.needs_input_grad[0]:
            gx = ConvInputGradFn.apply(gy, w, ctx.geo, tuple(x.shape[-2:]))
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(x, w.shape, gy, *ctx.geo)
        if ctx.needs_input_grad[2]:
            gb = gy.sum((0, 2, 3))
        return gx, gw, gb, None

    @staticmethod
    def vmap(info, in_dims, x, w, b, geo):
        xd, wd, bd, _ = in_dims
        if wd is not None or bd is not None:
            raise NotImplementedError("ConvFn.vmap: batched weight or bias")
        if xd is None:
            return ConvFn.apply(x, w, b, geo), None
        v = x.shape[xd]
        out = ConvFn.apply(_fold(x, xd), w, b, geo)
        return out.reshape(v, -1, *out.shape[1:]), 0


class ConvInputGradFn(torch.autograd.Function):
    """`conv_input_grad` as a Function, so that the vmapped cotangent
    sweeps fold their probes into its batch."""

    generate_vmap_rule = False

    @staticmethod
    def forward(gy, w, geo, in_hw):
        return conv_input_grad(gy, w, geo, in_hw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, gy, w, geo, in_hw):
        gd, wd = in_dims[:2]
        if wd is not None:
            raise NotImplementedError("ConvInputGradFn.vmap: batched weight")
        if gd is None:
            return ConvInputGradFn.apply(gy, w, geo, in_hw), None
        v = gy.shape[gd]
        out = ConvInputGradFn.apply(_fold(gy, gd), w, geo, in_hw)
        return out.reshape(v, -1, *out.shape[1:]), 0


def gemm_flop(x_shape, w_shape, geo: Geometry) -> float:
    """The implicit GEMM's operations: 2 N Ho Wo O C kh kw."""
    n, _, h, w = x_shape
    o, c, kh, kw = w_shape
    ho, wo = ((size + 2 * p - d * (k - 1) - 1) // s + 1 for size, p, d, k, s in
              zip((h, w), geo.padding, geo.dilation, (kh, kw), geo.stride))
    return 2.0 * n * ho * wo * o * c * kh * kw


def on_card_f32(x: torch.Tensor, w: torch.Tensor, padding, groups: int) -> bool:
    """An f32 convolution on the card (groups 1, explicit padding) under the
    f32 policy (cuDNN on, TF32 off): the route's domain."""
    return (x.is_cuda and x.dtype == torch.float32 and w.dtype == torch.float32
            and x.dim() == 4 and groups == 1 and not isinstance(padding, str)
            and torch.backends.cudnn.enabled and not torch.backends.cudnn.allow_tf32)


def takes_route(x: torch.Tensor, w: torch.Tensor, geo: Geometry) -> bool:
    """Whether an on_card_f32 convolution goes to the route: MIN_CHANNELS
    channels in and out or more, MIN_FLOP operations or more as its caller
    sees it (under vmap, a probe's share), and a kernel wider than 1x1 or
    MIN_1X1_OUT output channels."""
    o, c, kh, kw = w.shape
    return (min(o, c) >= MIN_CHANNELS and (kh * kw > 1 or o >= MIN_1X1_OUT)
            and gemm_flop(x.shape, w.shape, geo) >= MIN_FLOP)


def _undifferentiated(*ts) -> bool:
    """Nothing differentiates this call: no torch.func transform, no
    forward-AD level open, no input that records a graph."""
    return (not torch._C._are_functorch_transforms_active()
            and torch.autograd.forward_ad._current_level < 0
            and not (torch.is_grad_enabled()
                     and any(t is not None and t.requires_grad for t in ts)))


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """F.conv2d's arguments and result; a convolution `takes_route` admits
    goes through ConvFn, or straight to `conv_forward` where nothing
    differentiates it (Function.apply costs tens of microseconds of host
    time, which batch-1 sampling pays in every convolution). Overridable by
    a TorchFunctionMode, which is how spatial parallelism (parallel/sp.py)
    rewrites its height padding."""
    if has_torch_function_variadic(x, weight, bias):
        return handle_torch_function(conv2d, (x, weight, bias), x, weight, bias,
                                     stride, padding, dilation, groups)
    if not on_card_f32(x, weight, padding, groups):
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    geo = Geometry(_pair(stride), _pair(padding), _pair(dilation))
    gflop = gemm_flop(x.shape, weight.shape, geo) / 1e9
    count("conv_gflop", gflop)
    if not takes_route(x, weight, geo):
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    count("conv_tc_gflop", gflop)
    if _undifferentiated(x, weight, bias):
        return conv_forward(x, weight, bias, geo)
    return ConvFn.apply(x, weight, bias, geo)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (the same arguments, parameters and state_dict) whose
    zero-padded convolution goes through `conv2d`."""

    def _conv_forward(self, input, weight, bias):
        if self.padding_mode != "zeros":
            return super()._conv_forward(input, weight, bias)
        return conv2d(input, weight, bias, self.stride, self.padding, self.dilation,
                      self.groups)

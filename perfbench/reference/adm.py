"""Plain float32 ADM (guided-diffusion) U-Net: the reference the benchmark
holds the served FFHQ_P2 model to.

A frozen copy of the architecture in plain `torch` operations: GroupNorm(32)
in float32 by its definition, attention with the ADM double-sqrt scale (q
and k each times d^-1/4) and a float32 softmax, no kernels, no channels-last
layout. The module tree and the parameter names are the served model's, so
the benchmark hands the same weight tensors to both by name. It imports
nothing of the program.

`quant`, when set, rounds both operands of every product (convolutions,
dense layers, attention's two matrix products) before it, as a tensor
core of that precision takes them (the precision control of the
comparison, reference/loco.py::tf32_round); None computes in float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ADMSizes:
    image_size: int
    in_channels: int
    model_channels: int
    out_channels: int
    num_res_blocks: int
    attention_ds: tuple
    channel_mult: tuple
    num_head_channels: int = -1
    num_heads: int = 1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    learn_sigma: bool = True

    @classmethod
    def from_config(cls, model: dict) -> "ADMSizes":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in model.items() if k in fields}
        kw["attention_ds"] = tuple(kw["attention_ds"])
        kw["channel_mult"] = tuple(kw["channel_mult"])
        return cls(**kw)

    def heads_for(self, ch: int) -> int:
        return self.num_heads if self.num_head_channels == -1 else ch // self.num_head_channels


def layout(s: ADMSizes):
    """The ADM block sequence: (input blocks, middle, output blocks, final
    channels), each block a tuple of ("res", in, out, up, down) and
    ("attn", ch, heads) entries."""
    mc = s.model_channels
    ch = int(s.channel_mult[0] * mc)
    inputs = [(("conv", s.in_channels, ch),)]
    skips, ds = [ch], 1
    for level, mult in enumerate(s.channel_mult):
        for _ in range(s.num_res_blocks):
            layers = [("res", ch, int(mult * mc), False, False)]
            ch = int(mult * mc)
            if ds in s.attention_ds:
                layers.append(("attn", ch, s.heads_for(ch)))
            inputs.append(tuple(layers))
            skips.append(ch)
        if level != len(s.channel_mult) - 1:
            inputs.append((("res", ch, ch, False, True),))
            skips.append(ch)
            ds *= 2
    middle = (("res", ch, ch, False, False), ("attn", ch, s.heads_for(ch)),
              ("res", ch, ch, False, False))
    outputs = []
    for level, mult in list(enumerate(s.channel_mult))[::-1]:
        for i in range(s.num_res_blocks + 1):
            layers = [("res", ch + skips.pop(), int(mult * mc), False, False)]
            ch = int(mult * mc)
            if ds in s.attention_ds:
                layers.append(("attn", ch, s.heads_for(ch)))
            if level and i == s.num_res_blocks:
                layers.append(("res", ch, ch, True, False))
                ds //= 2
            outputs.append(tuple(layers))
    return tuple(inputs), middle, tuple(outputs), ch


class _Q:
    """Holds the optional rounding applied before each product."""

    quant = None

    def q(self, t):
        return t if self.quant is None else self.quant(t)


class Conv(nn.Module, _Q):
    def __init__(self, cin, cout, k=3, stride=1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.pad = stride, k // 2

    def forward(self, x):
        return F.conv2d(self.q(x), self.q(self.weight), self.bias, self.stride, self.pad)


class Dense(nn.Module, _Q):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class GroupNorm32(nn.Module):
    """GroupNorm over 32 groups by its definition (biased variance, eps
    1e-5), in float32."""

    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        b, c, h, w = x.shape
        g = x.float().reshape(b, 32, c // 32 * h * w)
        mean = g.mean(-1, keepdim=True)
        var = ((g - mean) ** 2).mean(-1, keepdim=True)
        y = ((g - mean) / torch.sqrt(var + 1e-5)).reshape(b, c, h, w)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def attention(q, k, v, rnd=lambda t: t):
    """softmax((q d^-1/4)(k d^-1/4)^T) v over (B, H, N, D); `rnd` rounds
    each product's operands."""
    s = q.shape[-1] ** -0.25
    w = torch.softmax(torch.matmul(rnd(q * s), rnd((k * s).transpose(-1, -2))).float(),
                      dim=-1)
    return torch.matmul(rnd(w), rnd(v))


class ResBlock(nn.Module):
    def __init__(self, cin, cout, up, down, s: ADMSizes):
        super().__init__()
        self.up, self.down, self.shift = up, down, s.use_scale_shift_norm
        self.in_norm = GroupNorm32(cin)
        self.in_conv = Conv(cin, cout)
        self.emb_dense = Dense(4 * s.model_channels, 2 * cout if self.shift else cout)
        self.out_norm = GroupNorm32(cout)
        self.out_conv = Conv(cout, cout)
        if cout != cin:
            self.skip_conv = Conv(cin, cout, k=1)

    def forward(self, x, emb):
        h = F.silu(self.in_norm(x))
        if self.up:
            h, x = (F.interpolate(t, scale_factor=2, mode="nearest") for t in (h, x))
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.in_conv(h)
        e = self.emb_dense(F.silu(emb))[:, :, None, None]
        if self.shift:
            scale, shift = e.chunk(2, dim=1)
            h = self.out_norm(h) * (1 + scale) + shift
        else:
            h = self.out_norm(h + e)
        h = self.out_conv(F.silu(h))
        if hasattr(self, "skip_conv"):
            x = self.skip_conv(x)
        return x + h


class AttentionBlock(nn.Module, _Q):
    def __init__(self, ch, heads):
        super().__init__()
        self.heads = heads
        self.norm = GroupNorm32(ch)
        self.qkv = Dense(ch, 3 * ch)
        self.proj_out = Dense(ch, ch)

    def forward(self, x):
        b, c, hh, ww = x.shape
        n = hh * ww
        t = self.norm(x).permute(0, 2, 3, 1).reshape(b, n, c)
        q, k, v = self.qkv(t).split(c, dim=-1)

        def split(z):
            return z.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        a = attention(split(q), split(k), split(v), self.q).transpose(1, 2).reshape(b, n, c)
        return x + self.proj_out(a).reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class _Seq(nn.Module):
    def __init__(self, specs, s: ADMSizes):
        super().__init__()
        self.names = []
        for i, spec in enumerate(specs):
            if spec[0] == "conv":
                name, mod = f"conv_{i}", Conv(spec[1], spec[2])
            elif spec[0] == "res":
                name, mod = f"res_{i}", ResBlock(*spec[1:], s)
            else:
                name, mod = f"attn_{i}", AttentionBlock(spec[1], spec[2])
            self.add_module(name, mod)
            self.names.append(name)

    def forward(self, h, emb):
        for name in self.names:
            mod = getattr(self, name)
            h = mod(h, emb) if isinstance(mod, ResBlock) else mod(h)
        return h


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


class ADM(nn.Module):
    """eps(x, t): x (B, H, W, C) NHWC, t a scalar timestep; float32."""

    def __init__(self, s: ADMSizes):
        super().__init__()
        self.sizes = s
        inputs, middle, outputs, ch = layout(s)
        for i, specs in enumerate(inputs):
            self.add_module(f"input_{i}", _Seq(specs, s))
        self.middle = _Seq(middle, s)
        for i, specs in enumerate(outputs):
            self.add_module(f"output_{i}", _Seq(specs, s))
        self.n_in, self.n_out = len(inputs), len(outputs)
        ted = 4 * s.model_channels
        self.time_dense0 = Dense(s.model_channels, ted)
        self.time_dense1 = Dense(ted, ted)
        self.out_norm = GroupNorm32(ch)
        self.out_conv = Conv(ch, s.out_channels)

    def set_quant(self, quant) -> "ADM":
        for m in self.modules():
            if isinstance(m, _Q):
                m.quant = quant
        return self

    def forward(self, x, t):
        b = x.shape[0]
        t = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        emb = self.time_dense1(F.silu(self.time_dense0(
            timestep_embedding(t, self.sizes.model_channels))))
        h = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(self.n_in):
            h = getattr(self, f"input_{i}")(h, emb)
            skips.append(h)
        h = self.middle(h, emb)
        for i in range(self.n_out):
            h = getattr(self, f"output_{i}")(torch.cat([h, skips.pop()], dim=1), emb)
        h = self.out_conv(F.silu(self.out_norm(h))).permute(0, 2, 3, 1)
        return h[..., :self.sizes.in_channels] if self.sizes.learn_sigma else h


def build(model: dict, device="meta") -> ADM:
    """The reference ADM at the configuration's sizes, on `device`, with
    uninitialized weights (load them by name)."""
    with torch.device(device):
        return ADM(ADMSizes.from_config(model))

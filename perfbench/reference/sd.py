"""Plain float32 Stable-Diffusion-family U-Net (with LCM's guidance
embedding) and VAE decoder: the reference the benchmark holds the served
LCM Dreamshaper v7 models to.

A frozen copy of the architectures in plain `torch` operations (diffusers'
UNet2DConditionModel and AutoencoderKL decoder): GroupNorm(32) by its
definition, LayerNorm, softmax attention with the 1/sqrt(d) scale, GEGLU
with the exact GELU. The module trees and parameter names are the served
models', so the benchmark hands the same weight tensors to both by name.
It imports nothing of the program. `set_quant` as in reference/adm.py.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.adm import Conv, Dense, _Q, timestep_embedding


class GroupNorm(nn.Module):
    def __init__(self, ch, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        b, c, h, w = x.shape
        g = x.reshape(b, 32, c // 32 * h * w)
        mean = g.mean(-1, keepdim=True)
        var = ((g - mean) ** 2).mean(-1, keepdim=True)
        y = ((g - mean) / torch.sqrt(var + self.eps)).reshape(b, c, h, w)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class LayerNorm(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5) * self.weight + self.bias


class Linear(nn.Module, _Q):
    """A dense layer with or without bias."""

    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


def attention(q, k, v, rnd=lambda t: t):
    """softmax(q k^T / sqrt(d)) v over (B, H, N, D); `rnd` rounds each
    product's operands."""
    w = torch.softmax(torch.matmul(rnd(q), rnd(k.transpose(-1, -2)))
                      / math.sqrt(q.shape[-1]), -1)
    return torch.matmul(rnd(w), rnd(v))


def tokens(x):
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def image(t, h, w):
    return t.reshape(t.shape[0], h, w, t.shape[-1]).permute(0, 3, 1, 2)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Resnet(nn.Module):
    def __init__(self, cin, cout, eps, temb=None):
        super().__init__()
        self.norm1 = GroupNorm(cin, eps)
        self.conv1 = Conv(cin, cout)
        if temb is not None:
            self.time_emb_proj = Dense(temb, cout)
        self.norm2 = GroupNorm(cout, eps)
        self.conv2 = Conv(cout, cout)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, k=1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module, _Q):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(ctx_dim, dim, bias=False)
        self.to_v = Linear(ctx_dim, dim, bias=False)
        self.to_out_0 = Linear(dim, dim)

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx

        def split(t):
            b, n, c = t.shape
            return t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        a = attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)),
                      self.q)
        b, _, n, _ = a.shape
        return self.to_out_0(a.transpose(1, 2).reshape(b, n, -1))


class GEGLU(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.proj = Linear(cin, 2 * cout)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class Block(nn.Module):
    def __init__(self, ch, heads, ctx_dim):
        super().__init__()
        self.norm1 = LayerNorm(ch)
        self.attn1 = CrossAttention(ch, ch, heads)
        self.norm2 = LayerNorm(ch)
        self.attn2 = CrossAttention(ch, ctx_dim, heads)
        self.norm3 = LayerNorm(ch)
        self.ff_net_0 = GEGLU(ch, 4 * ch)
        self.ff_net_2 = Linear(4 * ch, ch)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff_net_2(self.ff_net_0(self.norm3(x)))


class Transformer(nn.Module):
    def __init__(self, ch, heads, s: "UNetSizes"):
        super().__init__()
        self.linear = s.use_linear_projection
        self.norm = GroupNorm(ch, 1e-6)
        self.proj_in = Linear(ch, ch) if self.linear else Conv(ch, ch, k=1)
        self.proj_out = Linear(ch, ch) if self.linear else Conv(ch, ch, k=1)
        self.n = s.transformer_layers
        for i in range(self.n):
            self.add_module(f"block_{i}", Block(ch, heads, s.cross_attention_dim))

    def forward(self, x, ctx):
        hh, ww = x.shape[2:]
        h = self.norm(x)
        h = self.proj_in(tokens(h)) if self.linear else tokens(self.proj_in(h))
        for i in range(self.n):
            h = getattr(self, f"block_{i}")(h, ctx)
        h = image(self.proj_out(h), hh, ww) if self.linear else self.proj_out(image(h, hh, ww))
        return x + h


@dataclasses.dataclass(frozen=True)
class UNetSizes:
    sample_size: int
    in_channels: int
    out_channels: int
    block_out_channels: tuple
    layers_per_block: int
    cross_attention_dim: int
    attention_head_dim: tuple       # heads per level
    transformer_layers: int
    use_linear_projection: bool
    cross_attn_levels: tuple
    time_cond_proj_dim: int | None

    @classmethod
    def from_config(cls, d: dict) -> "UNetSizes":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)}
        for k in ("block_out_channels", "attention_head_dim", "cross_attn_levels"):
            kw[k] = tuple(kw[k])
        return cls(**kw)


def guidance_embedding(w, dim):
    """[sin|cos] with frequencies exp(-log(1e4) i / (half - 1)) of 1000 w."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device)
                      * -(math.log(10000.0) / (half - 1)))
    a = (w.float() * 1000.0)[:, None] * freqs[None]
    return torch.cat([torch.sin(a), torch.cos(a)], dim=-1)


class UNet(nn.Module):
    """eps(z, t, context, w): z (B, h, w, 4) NHWC, context (1, seq, dim), w
    the guidance scale fed to the guidance embedding; float32."""

    def __init__(self, s: UNetSizes):
        super().__init__()
        self.s = s
        ch0 = s.block_out_channels[0]
        ted = 4 * ch0
        if s.time_cond_proj_dim is not None:
            self.cond_proj = Linear(s.time_cond_proj_dim, ch0, bias=False)
        self.time_dense0 = Dense(ch0, ted)
        self.time_dense1 = Dense(ted, ted)
        self.conv_in = Conv(s.in_channels, ch0)
        n = len(s.block_out_channels)
        ch, skips = ch0, [ch0]
        for i, out in enumerate(s.block_out_channels):
            for j in range(s.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", Resnet(ch, out, 1e-5, ted))
                ch = out
                if s.cross_attn_levels[i]:
                    self.add_module(f"down_{i}_attn_{j}",
                                    Transformer(ch, s.attention_head_dim[i], s))
                skips.append(ch)
            if i != n - 1:
                self.add_module(f"down_{i}_downsample", Conv(ch, ch, stride=2))
                skips.append(ch)
        self.mid_res_0 = Resnet(ch, ch, 1e-5, ted)
        self.mid_attn = Transformer(ch, s.attention_head_dim[-1], s)
        self.mid_res_1 = Resnet(ch, ch, 1e-5, ted)
        for k in range(n):
            i = n - 1 - k
            for j in range(s.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                Resnet(ch + skips.pop(), s.block_out_channels[i], 1e-5, ted))
                ch = s.block_out_channels[i]
                if s.cross_attn_levels[i]:
                    self.add_module(f"up_{i}_attn_{j}",
                                    Transformer(ch, s.attention_head_dim[i], s))
            if i != 0:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch))
        self.conv_norm_out = GroupNorm(ch, 1e-5)
        self.conv_out = Conv(ch, s.out_channels)

    def set_quant(self, quant):
        for m in self.modules():
            if isinstance(m, _Q):
                m.quant = quant
        return self

    def forward(self, z, t, ctx, w=None):
        s = self.s
        b = z.shape[0]
        tt = torch.full((b,), float(t), dtype=torch.float32, device=z.device)
        temb = timestep_embedding(tt, s.block_out_channels[0])
        if s.time_cond_proj_dim is not None:
            ww = torch.full((b,), float(w), dtype=torch.float32, device=z.device)
            temb = temb + self.cond_proj(guidance_embedding(ww, s.time_cond_proj_dim))
        temb = self.time_dense1(F.silu(self.time_dense0(temb)))
        ctx = ctx.expand((b,) + tuple(ctx.shape[-2:]))
        h = self.conv_in(z.permute(0, 3, 1, 2))
        skips = [h]
        n = len(s.block_out_channels)
        for i in range(n):
            for j in range(s.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if s.cross_attn_levels[i]:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, ctx)
                skips.append(h)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, temb), ctx), temb)
        for k in range(n):
            i = n - 1 - k
            for j in range(s.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(torch.cat([h, skips.pop()], 1), temb)
                if s.cross_attn_levels[i]:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, ctx)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(up2(h))
        return self.conv_out(F.silu(self.conv_norm_out(h))).permute(0, 2, 3, 1)


class VAEAttention(nn.Module, _Q):
    def __init__(self, ch):
        super().__init__()
        self.group_norm = GroupNorm(ch, 1e-6)
        self.to_q, self.to_k = Linear(ch, ch), Linear(ch, ch)
        self.to_v, self.to_out_0 = Linear(ch, ch), Linear(ch, ch)

    def forward(self, x):
        hh, ww = x.shape[2:]
        h = tokens(self.group_norm(x))
        a = attention(self.to_q(h)[:, None], self.to_k(h)[:, None], self.to_v(h)[:, None],
                      self.q)
        return x + image(self.to_out_0(a[:, 0]), hh, ww)


class Decoder(nn.Module):
    """image(z): z (B, h, w, latent) NHWC, unscaled; float32."""

    def __init__(self, d: dict):
        super().__init__()
        chs = tuple(d["block_out_channels"])
        self.chs, self.lpb = chs, d["layers_per_block"]
        lat = d["latent_channels"]
        self.post_quant_conv = Conv(lat, lat, k=1)
        self.conv_in = Conv(lat, chs[-1])
        ch = chs[-1]
        self.mid_res_0 = Resnet(ch, ch, 1e-6)
        self.mid_attn = VAEAttention(ch)
        self.mid_res_1 = Resnet(ch, ch, 1e-6)
        for k, i in enumerate(reversed(range(len(chs)))):
            for j in range(self.lpb + 1):
                self.add_module(f"up_{i}_res_{j}", Resnet(ch, chs[i], 1e-6))
                ch = chs[i]
            if k != len(chs) - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch))
        self.conv_norm_out = GroupNorm(ch, 1e-6)
        self.conv_out = Conv(ch, d["out_channels"])

    set_quant = UNet.set_quant

    def forward(self, z):
        h = self.conv_in(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for k, i in enumerate(reversed(range(len(self.chs)))):
            for j in range(self.lpb + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if k != len(self.chs) - 1:
                h = getattr(self, f"up_{i}_upsample")(up2(h))
        return self.conv_out(F.silu(self.conv_norm_out(h))).permute(0, 2, 3, 1)


def build(config: dict, device="meta"):
    """(U-Net, decoder) at the configuration's sizes, weights uninitialized."""
    with torch.device(device):
        return (UNet(UNetSizes.from_config(config["unet"])), Decoder(config["vae"]))

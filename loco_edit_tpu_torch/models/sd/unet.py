"""SD-family conditional U-Net (UNet2DConditionModel-equivalent) as torch
modules (port of loco_edit_tpu/models/sd/unet.py).

Same function and the same parameter names as the Flax model, which follows
the SD checkpoint format:

  conv_in -> [CrossAttnDownBlock2D x3, DownBlock2D] -> mid(res, xattn, res)
          -> [UpBlock2D, CrossAttnUpBlock2D x3] -> GN/silu/conv_out

  - ResnetBlock2D: GN(32, eps 1e-5) + silu + conv; silu(temb) -> Linear
    added after conv1; 1x1 conv shortcut on a channel change.
  - Transformer2D: GN(32, eps 1e-6), linear (SD 2.x) or 1x1-conv (SD 1.x)
    projections; BasicTransformerBlock = self-attention, cross-attention on
    the text context, GEGLU feed-forward (exact erf GELU), each behind an
    f32 LayerNorm (eps 1e-5) whose f32 output the next Linear casts.
  - timestep embedding: the ADM formula ([cos|sin], exponent / half).
  - LCM: a bias-free projection of the guidance-scale embedding added to the
    time embedding's input.

The public layout is NHWC; inside, activations are NCHW tensors in
channels_last memory, as in models/adm/unet.py. Every GroupNorm goes through
ops.group_norm_f32 and every attention through ops.sdp_attention (q, k, v
as (B, H, N, D) views, k and v of N_kv = context length in the
cross-attention). Linear and conv weights are held in cfg.dtype, the time
MLP and conv_out in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from loco_edit_tpu_torch.core.device import to_device
from loco_edit_tpu_torch.models.adm.unet import timestep_embedding
from loco_edit_tpu_torch.models.base import init_random_weights_
from loco_edit_tpu_torch.models.sd.config import SDUNetConfig, check_no_remat
from loco_edit_tpu_torch.ops import Conv2d, group_norm_f32, sdp_attention


class GroupNormF32(nn.Module):
    """GroupNorm(32) computed in f32, params f32, output in the input dtype."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return group_norm_f32(x, self.weight, self.bias, eps=self.eps)


def _conv(in_ch: int, out_ch: int, dtype: torch.dtype, kernel: int = 3,
          stride: int = 1) -> Conv2d:
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2,
                  dtype=dtype)


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) channels_last -> (B, H*W, C) (a view)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def from_tokens(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W) channels_last (a view)."""
    return t.reshape(t.shape[0], h, w, t.shape[-1]).permute(0, 3, 1, 2)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, cfg: SDUNetConfig, eps: float = 1e-5):
        super().__init__()
        dt = cfg.dtype
        self.norm1 = GroupNormF32(in_ch, eps)
        self.conv1 = _conv(in_ch, out_ch, dt)
        self.time_emb_proj = nn.Linear(cfg.time_embed_dim, out_ch, dtype=dt)
        self.norm2 = GroupNormF32(out_ch, eps)
        self.conv2 = _conv(out_ch, out_ch, dt)
        if in_ch != out_ch:
            self.conv_shortcut = _conv(in_ch, out_ch, dt, kernel=1)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        e = self.time_emb_proj(F.silu(temb))
        h = h + e[:, :, None, None].to(h.dtype)
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention with bias-free q/k/v projections; k and v from
    the context (cross-attention) or from x (self-attention)."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dtype):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False, dtype=dtype)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False, dtype=dtype)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False, dtype=dtype)
        self.to_out_0 = nn.Linear(query_dim, query_dim, dtype=dtype)

    def forward(self, x, context=None):
        context = x if context is None else context
        dt = self.to_q.weight.dtype
        x, context = x.to(dt), context.to(dt)
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)

        def split(t):
            b, n, inner = t.shape
            return t.reshape(b, n, self.heads, inner // self.heads).transpose(1, 2)

        a = sdp_attention(split(q), split(k), split(v))
        b, _, n, _ = a.shape
        return self.to_out_0(a.transpose(1, 2).reshape(b, n, -1))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out, dtype=dtype)

    def forward(self, x):
        h, gate = self.proj(x.to(self.proj.weight.dtype)).chunk(2, dim=-1)
        return h * F.gelu(gate)             # the exact erf form, as diffusers'


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed and returned in f32 (Flax LayerNorm, dtype f32)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class BasicTransformerBlock(nn.Module):
    def __init__(self, ch: int, heads: int, cfg: SDUNetConfig):
        super().__init__()
        dt = cfg.dtype
        self.norm1 = LayerNormF32(ch, eps=1e-5)
        self.attn1 = CrossAttention(ch, ch, heads, dt)
        self.norm2 = LayerNormF32(ch, eps=1e-5)
        self.attn2 = CrossAttention(ch, cfg.cross_attention_dim, heads, dt)
        self.norm3 = LayerNormF32(ch, eps=1e-5)
        self.ff_net_0 = GEGLU(ch, 4 * ch, dt)
        self.ff_net_2 = nn.Linear(4 * ch, ch, dtype=dt)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        h = self.ff_net_0(self.norm3(x))
        return x + self.ff_net_2(h)


class Transformer2D(nn.Module):
    def __init__(self, ch: int, heads: int, cfg: SDUNetConfig):
        super().__init__()
        self.linear = cfg.use_linear_projection
        dt = cfg.dtype
        self.norm = GroupNormF32(ch, 1e-6)
        if self.linear:
            self.proj_in = nn.Linear(ch, ch, dtype=dt)
            self.proj_out = nn.Linear(ch, ch, dtype=dt)
        else:
            self.proj_in = _conv(ch, ch, dt, kernel=1)
            self.proj_out = _conv(ch, ch, dt, kernel=1)
        self.n_layers = cfg.transformer_layers
        for i in range(cfg.transformer_layers):
            self.add_module(f"block_{i}", BasicTransformerBlock(ch, heads, cfg))

    def forward(self, x, context):
        hh, ww = x.shape[2:]
        h = self.norm(x)
        h = self.proj_in(to_tokens(h)) if self.linear else to_tokens(self.proj_in(h))
        for i in range(self.n_layers):
            h = getattr(self, f"block_{i}")(h, context)
        if self.linear:
            h = from_tokens(self.proj_out(h), hh, ww)
        else:
            h = self.proj_out(from_tokens(h, hh, ww))
        return x + h


class SDUNet(nn.Module):
    """x: (B, H, W, C_lat) NHWC latents; t: scalar or (B,); context:
    (B or 1, seq, cross_attention_dim) text-encoder hidden states; w:
    optional (B,) LCM guidance scales. Returns eps (B, H, W, out) in f32."""

    def __init__(self, cfg: SDUNetConfig):
        super().__init__()
        check_no_remat(cfg, "SDUNet")
        self.cfg = cfg
        dt = cfg.dtype
        ch0 = cfg.block_out_channels[0]
        ted = cfg.time_embed_dim
        if cfg.time_cond_proj_dim is not None:
            self.cond_proj = nn.Linear(cfg.time_cond_proj_dim, ch0, bias=False)
        self.time_dense0 = nn.Linear(ch0, ted)
        self.time_dense1 = nn.Linear(ted, ted)
        self.conv_in = _conv(cfg.in_channels, ch0, dt)
        n = len(cfg.block_out_channels)
        ch = ch0
        skip_chs = [ch]
        for i, out_ch in enumerate(cfg.block_out_channels):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock2D(ch, out_ch, cfg))
                ch = out_ch
                if cfg.cross_attn_levels[i]:
                    self.add_module(f"down_{i}_attn_{j}",
                                    Transformer2D(ch, cfg.attention_head_dim[i], cfg))
                skip_chs.append(ch)
            if i != n - 1:
                self.add_module(f"down_{i}_downsample", _conv(ch, ch, dt, stride=2))
                skip_chs.append(ch)
        self.mid_res_0 = ResnetBlock2D(ch, ch, cfg)
        self.mid_attn = Transformer2D(ch, cfg.attention_head_dim[-1], cfg)
        self.mid_res_1 = ResnetBlock2D(ch, ch, cfg)
        for k in range(n):
            i = n - 1 - k
            out_ch = cfg.block_out_channels[i]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock2D(ch + skip_chs.pop(), out_ch, cfg))
                ch = out_ch
                if cfg.cross_attn_levels[i]:
                    self.add_module(f"up_{i}_attn_{j}",
                                    Transformer2D(ch, cfg.attention_head_dim[i], cfg))
            if i != 0:
                self.add_module(f"up_{i}_upsample", _conv(ch, ch, dt))
        self.conv_norm_out = GroupNormF32(ch, 1e-5)
        self.conv_out = _conv(ch, cfg.out_channels, torch.float32)

    def init_random_(self, generator: torch.Generator) -> "SDUNet":
        """Seeded random weights (models/base.py::init_random_weights_)."""
        init_random_weights_(self, generator)
        return self

    def forward(self, x, t, context, w=None):
        cfg = self.cfg
        b = x.shape[0]
        t = to_device(t, x.device)
        t = torch.broadcast_to(t.reshape(-1), (b,))
        context = torch.broadcast_to(
            context, (b,) + tuple(context.shape[-2:])).to(cfg.dtype)
        ch0 = cfg.block_out_channels[0]
        temb = timestep_embedding(t, ch0)
        if cfg.time_cond_proj_dim is not None:
            if w is None:
                raise ValueError("this UNet is guidance-embedding conditioned; pass w")
            from loco_edit_tpu_torch.models.ddpm.unet import ddpm_timestep_embedding

            w = to_device(w, x.device)
            w_emb = ddpm_timestep_embedding(
                torch.broadcast_to(w.reshape(-1), (b,)) * 1000.0,
                cfg.time_cond_proj_dim)
            temb = temb + self.cond_proj(w_emb)
        temb = self.time_dense1(F.silu(self.time_dense0(temb))).to(cfg.dtype)

        h = self.conv_in(x.permute(0, 3, 1, 2).to(cfg.dtype))
        skips = [h]
        n = len(cfg.block_out_channels)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if cfg.cross_attn_levels[i]:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                skips.append(h)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)

        h = self.mid_res_0(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, temb)

        for k in range(n):
            i = n - 1 - k
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(torch.cat([h, skips.pop()], dim=1),
                                                     temb)
                if cfg.cross_attn_levels[i]:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, context)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(
                    F.interpolate(h, scale_factor=2, mode="nearest"))

        h = F.silu(self.conv_norm_out(h)).to(x.dtype).float()
        return self.conv_out(h).permute(0, 2, 3, 1)     # back to NHWC, f32

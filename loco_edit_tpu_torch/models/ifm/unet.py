"""DeepFloyd-IF pixel-space conditional U-Net with added-KV attention, as
torch modules (port of loco_edit_tpu/models/ifm/unet.py).

The function and the parameter names of the Flax model (which follows the
diffusers UNet2DConditionModel of the IF checkpoints):

  - IFAttention: "simple" added-KV attention. q, k, v come from the
    GroupNorm-ed image tokens; the text states, normalized by `norm_cross`
    (GroupNorm(32) over the embedding channels in the IF configs), add
    extra key / value tokens through add_k_proj / add_v_proj, concatenated
    text first before one softmax: N_kv = 77 + H * W.
  - IFResBlock: scale-shift time conditioning, up/downsampling inside the
    block (the h path and the residual nearest-upsampled / avg-pooled), a
    1x1 shortcut only where in_ch != out_ch.
  - exact-erf GELU (act_fn "gelu") in the res blocks, the time MLP, the
    stage-2 class (aug-level) MLP and the output head. The class MLP is the
    one departure from the JAX package, which keeps SiLU there: diffusers
    builds the class TimestepEmbedding with the U-Net's act_fn.
  - T5 states projected by encoder_hid_proj, plus the "text" addition
    embedding (TextTimeEmbedding: LayerNorm, a one-query attention pool,
    Linear, LayerNorm on the raw states) added to the time embedding.
  - stage 2 concatenates the noise-augmented upsampled stage-1 image on
    channels (in_channels 6) and embeds the aug level (class_embed_timestep).
  - learned sigma: out_channels = 2 x image channels.

Activations are NCHW tensors in channels_last memory, the public layout
NHWC, as in models/sd/unet.py. Every GroupNorm (norm_cross included, as a
(B, C, 1, 77) tensor) is models/sd/unet.py's GroupNormF32, through
ops.group_norm_f32, and every attention
through ops.sdp_attention; TextTimeEmbedding's pool is a plain f32 einsum,
as in the JAX package (no Pallas kernel there). Linear and conv weights are
held in cfg.dtype, the time / class MLPs, the addition embedding and
conv_out in f32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from loco_edit_tpu_torch.models.adm.unet import timestep_embedding
from loco_edit_tpu_torch.models.base import init_random_weights_
from loco_edit_tpu_torch.models.sd.unet import (GroupNormF32, LayerNormF32, _conv,
                                                from_tokens, to_tokens)
from loco_edit_tpu_torch.ops import sdp_attention


@dataclasses.dataclass(frozen=True)
class IFUNetConfig:
    sample_size: int = 64
    in_channels: int = 3
    out_channels: int = 6                # eps | sigma
    block_out_channels: tuple[int, ...] = (64, 128, 256, 512)
    layers_per_block: int | tuple[int, ...] = 2
    encoder_hid_dim: int = 4096          # T5-XXL hidden size
    cross_attention_dim: int = 512
    attention_head_dim: int = 64
    # level 0 is a pure resnet block (no attention), as IF's layout
    attn_levels: tuple[bool, ...] = (False, True, True, True)
    act_fn: str = "silu"                 # IF presets: "gelu" (exact erf)
    cross_attention_norm: str = "layer_norm"  # IF presets: "group_norm"
    use_addition_text_embed: bool = False
    addition_embed_num_heads: int = 64
    class_embed_timestep: bool = False   # IF-II aug-level conditioning
    dtype: torch.dtype = torch.float32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def lpb(self, level: int) -> int:
        if isinstance(self.layers_per_block, int):
            return self.layers_per_block
        return self.layers_per_block[level]


def _act(cfg: IFUNetConfig):
    return F.gelu if cfg.act_fn == "gelu" else F.silu


class IFResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, cfg: IFUNetConfig,
                 up: bool = False, down: bool = False):
        super().__init__()
        dt = cfg.dtype
        self.act, self.up, self.down = _act(cfg), up, down
        self.norm1 = GroupNormF32(in_ch)
        self.conv1 = _conv(in_ch, out_ch, dt)
        self.time_emb_proj = nn.Linear(cfg.time_embed_dim, 2 * out_ch, dtype=dt)
        self.norm2 = GroupNormF32(out_ch)
        self.conv2 = _conv(out_ch, out_ch, dt)
        if in_ch != out_ch:
            self.conv_shortcut = _conv(in_ch, out_ch, dt, kernel=1)

    def forward(self, x, temb):
        h = self.act(self.norm1(x))
        if self.up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif self.down:
            h = F.avg_pool2d(h, 2)
            x = F.avg_pool2d(x, 2)
        h = self.conv1(h)
        e = self.time_emb_proj(self.act(temb))[:, :, None, None].to(h.dtype)
        scale, shift = e.chunk(2, dim=1)
        h = self.act(self.norm2(h) * (1 + scale) + shift)
        h = self.conv2(h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class IFAttention(nn.Module):
    """Added-KV attention over the image tokens and the normalized text
    states (text keys first)."""

    def __init__(self, ch: int, cfg: IFUNetConfig):
        super().__init__()
        dt, xd = cfg.dtype, cfg.cross_attention_dim
        self.heads = max(ch // cfg.attention_head_dim, 1)
        self.cfg = cfg
        self.group_norm = GroupNormF32(ch)
        self.norm_cross = (GroupNormF32(xd) if cfg.cross_attention_norm == "group_norm"
                           else LayerNormF32(xd, eps=1e-5))
        for name in ("to_q", "to_k", "to_v", "to_out_0"):
            setattr(self, name, nn.Linear(ch, ch, dtype=dt))
        self.add_k_proj = nn.Linear(xd, ch, dtype=dt)
        self.add_v_proj = nn.Linear(xd, ch, dtype=dt)

    def norm_context(self, ctx):
        """norm_cross on (B, seq, dim) states: GroupNorm over the channels
        with statistics pooled over the sequence, taken as a (B, dim, 1,
        seq) channels_last image."""
        if isinstance(self.norm_cross, GroupNormF32):
            b, s, c = ctx.shape
            img = ctx.reshape(b, 1, s, c).permute(0, 3, 1, 2)
            return to_tokens(self.norm_cross(img))
        return self.norm_cross(ctx)

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        tokens = to_tokens(self.group_norm(x))
        ctx = self.norm_context(ctx).to(self.cfg.dtype)
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        k = torch.cat([self.add_k_proj(ctx), k], dim=1)
        v = torch.cat([self.add_v_proj(ctx), v], dim=1)

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, c // self.heads).transpose(1, 2)

        a = sdp_attention(split(q), split(k), split(v))
        a = self.to_out_0(a.transpose(1, 2).reshape(b, hh * ww, c))
        return x + from_tokens(a, hh, ww)


class TextTimeEmbedding(nn.Module):
    """diffusers TextTimeEmbedding on the raw T5 states, in f32: LayerNorm,
    a one-query attention pool (the mean token plus a learned positional
    embedding attending over [query; tokens], multi-head, q and k each
    scaled by d^-1/4), Linear to the time embedding width, LayerNorm."""

    def __init__(self, cfg: IFUNetConfig):
        super().__init__()
        e = cfg.encoder_hid_dim
        self.heads = cfg.addition_embed_num_heads
        self.norm1 = LayerNormF32(e, eps=1e-5)
        self.positional_embedding = nn.Parameter(torch.zeros(1, e))
        self.q_proj = nn.Linear(e, e)
        self.k_proj = nn.Linear(e, e)
        self.v_proj = nn.Linear(e, e)
        self.proj = nn.Linear(e, cfg.time_embed_dim)
        self.norm2 = LayerNormF32(cfg.time_embed_dim, eps=1e-5)

    def forward(self, ctx):
        b, _, e = ctx.shape
        d = e // self.heads
        x = self.norm1(ctx.float())
        cls = x.mean(dim=1, keepdim=True) + self.positional_embedding
        cat = torch.cat([cls, x], dim=1)

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, d).transpose(1, 2)

        sc = d ** -0.25
        logits = torch.einsum("bhqd,bhkd->bhqk", split(self.q_proj(cls)) * sc,
                              split(self.k_proj(cat)) * sc)
        a = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1),
                         split(self.v_proj(cat)))
        return self.norm2(self.proj(a.transpose(1, 2).reshape(b, e)))


class IFUNet(nn.Module):
    """x: (B, H, W, C) NHWC pixels; t: scalar or (B,); ctx: (B or 1, seq,
    encoder_hid_dim) T5 states; aug_t: the stage-2 noise-augmentation level
    (scalar or (B,), read when cfg.class_embed_timestep). Returns (B, H, W,
    out_channels) = [eps | sigma] in f32."""

    def __init__(self, cfg: IFUNetConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        ch0, ted = cfg.block_out_channels[0], cfg.time_embed_dim
        self.act = _act(cfg)
        self.time_dense0 = nn.Linear(ch0, ted)
        self.time_dense1 = nn.Linear(ted, ted)
        if cfg.class_embed_timestep:
            self.class_dense0 = nn.Linear(ch0, ted)
            self.class_dense1 = nn.Linear(ted, ted)
        if cfg.use_addition_text_embed:
            self.add_embedding = TextTimeEmbedding(cfg)
        self.encoder_hid_proj = nn.Linear(cfg.encoder_hid_dim, cfg.cross_attention_dim,
                                          dtype=dt)
        self.conv_in = _conv(cfg.in_channels, ch0, dt)
        n = len(cfg.block_out_channels)
        ch, skip_chs = ch0, [ch0]
        for i, out_ch in enumerate(cfg.block_out_channels):
            for j in range(cfg.lpb(i)):
                self.add_module(f"down_{i}_res_{j}", IFResBlock(ch, out_ch, cfg))
                ch = out_ch
                if cfg.attn_levels[i]:
                    self.add_module(f"down_{i}_attn_{j}", IFAttention(ch, cfg))
                skip_chs.append(ch)
            if i != n - 1:
                self.add_module(f"down_{i}_downsample", IFResBlock(ch, ch, cfg, down=True))
                skip_chs.append(ch)
        self.mid_res_0 = IFResBlock(ch, ch, cfg)
        self.mid_attn = IFAttention(ch, cfg)
        self.mid_res_1 = IFResBlock(ch, ch, cfg)
        for k in range(n):
            i = n - 1 - k
            out_ch = cfg.block_out_channels[i]
            for j in range(cfg.lpb(i) + 1):
                self.add_module(f"up_{i}_res_{j}",
                                IFResBlock(ch + skip_chs.pop(), out_ch, cfg))
                ch = out_ch
                if cfg.attn_levels[i]:
                    self.add_module(f"up_{i}_attn_{j}", IFAttention(ch, cfg))
            if i != 0:
                self.add_module(f"up_{i}_upsample", IFResBlock(ch, ch, cfg, up=True))
        self.conv_norm_out = GroupNormF32(ch)
        self.conv_out = _conv(ch, cfg.out_channels, torch.float32)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "IFUNet":
        """Seeded random weights (models/base.py::init_random_weights_; the
        pool's positional embedding normal of std E^-1/2, as Flax's init)."""
        init_random_weights_(self, generator)
        if self.cfg.use_addition_text_embed:
            pe = self.add_embedding.positional_embedding
            pe.copy_(torch.randn(pe.shape, generator=generator, device=pe.device)
                     * self.cfg.encoder_hid_dim ** -0.5)
        return self

    def forward(self, x, t, ctx, aug_t=None):
        cfg = self.cfg
        b = x.shape[0]

        def per_batch(v):
            v = torch.as_tensor(v, dtype=torch.float32, device=x.device)
            return torch.broadcast_to(v.reshape(-1), (b,))

        ctx = torch.broadcast_to(ctx, (b,) + tuple(ctx.shape[-2:]))
        ch0 = cfg.block_out_channels[0]
        temb = self.time_dense1(self.act(self.time_dense0(
            timestep_embedding(per_batch(t), ch0))))
        if cfg.class_embed_timestep:
            aug = per_batch(0.0 if aug_t is None else aug_t)
            temb = temb + self.class_dense1(self.act(self.class_dense0(
                timestep_embedding(aug, ch0))))
        if cfg.use_addition_text_embed:
            temb = temb + self.add_embedding(ctx)
        temb = temb.to(cfg.dtype)
        ctx_proj = self.encoder_hid_proj(ctx.to(cfg.dtype))

        h = self.conv_in(x.permute(0, 3, 1, 2).to(cfg.dtype))
        skips = [h]
        n = len(cfg.block_out_channels)
        for i in range(n):
            for j in range(cfg.lpb(i)):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if cfg.attn_levels[i]:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, ctx_proj)
                skips.append(h)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample")(h, temb)
                skips.append(h)

        h = self.mid_res_0(h, temb)
        h = self.mid_attn(h, ctx_proj)
        h = self.mid_res_1(h, temb)

        for k in range(n):
            i = n - 1 - k
            for j in range(cfg.lpb(i) + 1):
                h = getattr(self, f"up_{i}_res_{j}")(torch.cat([h, skips.pop()], dim=1),
                                                     temb)
                if cfg.attn_levels[i]:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, ctx_proj)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h, temb)

        h = self.act(self.conv_norm_out(h)).to(x.dtype).float()
        return self.conv_out(h).permute(0, 2, 3, 1)     # back to NHWC, f32

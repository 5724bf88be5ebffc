"""AutoencoderKL (the SD VAE) as torch modules (port of
loco_edit_tpu/models/sd/vae.py).

The edit differentiates through the decoder (the PMP is decoded before the
Jacobian is taken), so the decoder is a module like the U-Net, under the
same torch.func transforms; the encoder gives the latent distribution for
the DDIM inversion of a real image.

  encoder: conv_in -> 4 down blocks (2 resnets each, GN eps 1e-6, no temb;
           asymmetric (0, 1, 0, 1) pad + VALID stride-2 conv) ->
           mid(res, attn, res) -> GN/silu/conv_out (2 x latent ch) ->
           quant_conv 1x1; logvar clipped to [-30, 20]
  decoder: post_quant_conv 1x1 -> conv_in -> mid(res, attn, res) ->
           4 up blocks (3 resnets, nearest-up + conv) -> GN/silu/conv_out

The attention is single-head with D = C (512 at SD's width): the attention
kernel's wide-head route. Public layout NHWC, channels_last inside; convs in
cfg.dtype, conv_out (and the encoder's quant_conv) in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from loco_edit_tpu_torch.models.base import init_random_weights_
from loco_edit_tpu_torch.models.sd.config import VAEConfig, check_no_remat
from loco_edit_tpu_torch.models.sd.unet import GroupNormF32, _conv, from_tokens, to_tokens
from loco_edit_tpu_torch.ops import Conv2d, sdp_attention


def _gn(ch: int) -> GroupNormF32:
    return GroupNormF32(ch, 1e-6)


class VAEResnet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype):
        super().__init__()
        self.norm1 = _gn(in_ch)
        self.conv1 = _conv(in_ch, out_ch, dtype)
        self.norm2 = _gn(out_ch)
        self.conv2 = _conv(out_ch, out_ch, dtype)
        if in_ch != out_ch:
            self.conv_shortcut = _conv(in_ch, out_ch, dtype, kernel=1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over H*W tokens, head dim = channels."""

    def __init__(self, ch: int, dtype):
        super().__init__()
        self.group_norm = _gn(ch)
        self.to_q = nn.Linear(ch, ch, dtype=dtype)
        self.to_k = nn.Linear(ch, ch, dtype=dtype)
        self.to_v = nn.Linear(ch, ch, dtype=dtype)
        self.to_out_0 = nn.Linear(ch, ch, dtype=dtype)

    def forward(self, x):
        hh, ww = x.shape[2:]
        h = to_tokens(self.group_norm(x))
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        a = sdp_attention(q[:, None], k[:, None], v[:, None])[:, 0]
        return x + from_tokens(self.to_out_0(a), hh, ww)


class _VAEPart(nn.Module):
    def init_random_(self, generator: torch.Generator):
        """Seeded random weights (models/base.py::init_random_weights_)."""
        init_random_weights_(self, generator)
        return self


class VAEEncoder(_VAEPart):
    """x: (B, H, W, 3) NHWC in [-1, 1]. Returns (mean, logvar), each
    (B, H/8, W/8, latent) NHWC f32."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        check_no_remat(cfg, "VAEEncoder")
        self.cfg = cfg
        dt, chs = cfg.dtype, cfg.block_out_channels
        self.conv_in = _conv(cfg.in_channels, chs[0], dt)
        ch = chs[0]
        for i, out_ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", VAEResnet(ch, out_ch, dt))
                ch = out_ch
            if i != len(chs) - 1:
                self.add_module(f"down_{i}_downsample",
                                Conv2d(ch, ch, 3, stride=2, padding=0, dtype=dt))
        self.mid_res_0 = VAEResnet(ch, ch, dt)
        self.mid_attn = VAEAttention(ch, dt)
        self.mid_res_1 = VAEResnet(ch, ch, dt)
        self.conv_norm_out = _gn(ch)
        self.conv_out = _conv(ch, 2 * cfg.latent_channels, torch.float32)
        self.quant_conv = _conv(2 * cfg.latent_channels, 2 * cfg.latent_channels,
                                torch.float32, kernel=1)

    def forward(self, x):
        cfg = self.cfg
        chs = cfg.block_out_channels
        h = self.conv_in(x.permute(0, 3, 1, 2).to(cfg.dtype))
        for i in range(len(chs)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i != len(chs) - 1:
                h = getattr(self, f"down_{i}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        h = F.silu(self.conv_norm_out(h)).float()
        h = self.quant_conv(self.conv_out(h)).permute(0, 2, 3, 1)
        mean, logvar = h.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


class VAEDecoder(_VAEPart):
    """z: (B, h, w, latent) NHWC (unscaled). Returns images (B, 8h, 8w, 3)
    NHWC f32."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        check_no_remat(cfg, "VAEDecoder")
        self.cfg = cfg
        dt, chs = cfg.dtype, cfg.block_out_channels
        self.post_quant_conv = _conv(cfg.latent_channels, cfg.latent_channels, dt,
                                     kernel=1)
        self.conv_in = _conv(cfg.latent_channels, chs[-1], dt)
        ch = chs[-1]
        self.mid_res_0 = VAEResnet(ch, ch, dt)
        self.mid_attn = VAEAttention(ch, dt)
        self.mid_res_1 = VAEResnet(ch, ch, dt)
        for k, i in enumerate(reversed(range(len(chs)))):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", VAEResnet(ch, chs[i], dt))
                ch = chs[i]
            if k != len(chs) - 1:
                self.add_module(f"up_{i}_upsample", _conv(ch, ch, dt))
        self.conv_norm_out = _gn(ch)
        self.conv_out = _conv(ch, cfg.out_channels, torch.float32)

    def forward(self, z):
        cfg = self.cfg
        chs = cfg.block_out_channels
        h = self.post_quant_conv(z.permute(0, 3, 1, 2).to(cfg.dtype))
        h = self.conv_in(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for k, i in enumerate(reversed(range(len(chs)))):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if k != len(chs) - 1:
                h = getattr(self, f"up_{i}_upsample")(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        h = F.silu(self.conv_norm_out(h)).float()
        return self.conv_out(h).permute(0, 2, 3, 1)


def encode_sample(mean: torch.Tensor, logvar: torch.Tensor, rng,
                  scaling_factor: float = 0.18215) -> torch.Tensor:
    """latent_dist.sample() * scaling_factor, the noise drawn from the
    stream `rng` (an RngStream, or anything with normal(shape, device=,
    dtype=)) in the NHWC shape of mean."""
    std = torch.exp(0.5 * logvar)
    noise = rng.normal(mean.shape, device=mean.device, dtype=mean.dtype)
    return (mean + std * noise) * scaling_factor

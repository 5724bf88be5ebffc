"""Classic DDPM (Ho et al. / SDEdit) U-Net as torch modules (port of
loco_edit_tpu/models/ddpm/unet.py).

Same function and the same parameter names as the Flax model, which is the
architecture of the HF `google/ddpm-ema-*` checkpoints the *_HF model names
load. Its fingerprints, kept exactly:

  - GroupNorm(32, eps=1e-6), in f32 (ops.group_norm_f32);
  - [sin|cos] timestep embedding with exp(-log(1e4) * i / (half - 1)) (the
    /(half - 1) and the sin-first order both differ from ADM's embedding);
  - swish; temb projected and ADDED after conv1;
  - single-head attention over separate q/k/v dense layers with the head
    dim equal to the channel count, through ops.sdp_attention on
    (B, 1, N, C);
  - downsample: stride-2 conv with asymmetric (0, 1, 0, 1) padding;
    upsample: nearest x2 then conv;
  - attention after each res block at matching resolutions; the skip stack
    holds conv_in and the downsample outputs;
  - conv_out in f32 on the activations cast to the input dtype.

The public layout is NHWC; inside, activations are NCHW tensors in
channels_last memory, as in models/adm/unet.py.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from loco_edit_tpu_torch.models.base import init_random_weights_
from loco_edit_tpu_torch.ops import Conv2d, group_norm_f32, sdp_attention


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple[int, ...] = (16,)
    dropout: float = 0.0                 # active only in training mode
    resamp_with_conv: bool = True
    dtype: torch.dtype = torch.float32   # compute dtype of convs / dense layers

    @property
    def temb_ch(self) -> int:
        return self.ch * 4


def ddpm_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin|cos] embedding with frequencies exp(-log(1e4) * i / (half - 1)).
    Always float32."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Norm(nn.Module):
    """GroupNorm(32, eps=1e-6) computed in f32, params f32, output in the
    input dtype."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return group_norm_f32(x, self.weight, self.bias, eps=1e-6)


def _conv(in_ch: int, out_ch: int, dtype: torch.dtype, kernel: int = 3,
          stride: int = 1, padding: int | None = None) -> Conv2d:
    return Conv2d(in_ch, out_ch, kernel, stride=stride,
                  padding=kernel // 2 if padding is None else padding, dtype=dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, cfg: DDPMConfig):
        super().__init__()
        self.norm1 = Norm(in_ch)
        self.conv1 = _conv(in_ch, out_ch, cfg.dtype)
        self.temb_proj = nn.Linear(cfg.temb_ch, out_ch, dtype=cfg.dtype)
        self.norm2 = Norm(out_ch)
        if cfg.dropout > 0:
            self.dropout = nn.Dropout(cfg.dropout)
        self.conv2 = _conv(out_ch, out_ch, cfg.dtype)
        if in_ch != out_ch:
            self.nin_shortcut = _conv(in_ch, out_ch, cfg.dtype, kernel=1)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        e = self.temb_proj(F.silu(temb))
        h = h + e[:, :, None, None].to(h.dtype)
        h = F.silu(self.norm2(h))
        if hasattr(self, "dropout"):
            h = self.dropout(h)
        h = self.conv2(h)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over H*W tokens, head dim = channels."""

    def __init__(self, ch: int, cfg: DDPMConfig):
        super().__init__()
        self.norm = Norm(ch)
        self.q = nn.Linear(ch, ch, dtype=cfg.dtype)
        self.k = nn.Linear(ch, ch, dtype=cfg.dtype)
        self.v = nn.Linear(ch, ch, dtype=cfg.dtype)
        self.proj_out = nn.Linear(ch, ch, dtype=cfg.dtype)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.q(h), self.k(h), self.v(h)
        a = sdp_attention(q[:, None], k[:, None], v[:, None])[:, 0]
        a = self.proj_out(a)
        return x + a.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class DDPMUNet(nn.Module):
    """x: (B, H, W, C) NHWC; t: scalar or (B,) timesteps. Returns eps
    (B, H, W, out_ch) in f32."""

    def __init__(self, cfg: DDPMConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        num_res = len(cfg.ch_mult)
        in_mult = (1,) + tuple(cfg.ch_mult)
        self.temb_dense0 = nn.Linear(cfg.ch, cfg.temb_ch)
        self.temb_dense1 = nn.Linear(cfg.temb_ch, cfg.temb_ch)
        self.conv_in = _conv(cfg.in_channels, cfg.ch, dt)

        curr_res = cfg.resolution
        for i in range(num_res):
            block_in = cfg.ch * in_mult[i]
            block_out = cfg.ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{i}_block_{j}",
                                ResnetBlock(block_in, block_out, cfg))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    self.add_module(f"down_{i}_attn_{j}", AttnBlock(block_in, cfg))
            if i != num_res - 1:
                if cfg.resamp_with_conv:
                    self.add_module(f"down_{i}_downsample",
                                    _conv(block_in, block_in, dt, stride=2, padding=0))
                curr_res //= 2

        self.mid_block_1 = ResnetBlock(block_in, block_in, cfg)
        self.mid_attn_1 = AttnBlock(block_in, cfg)
        self.mid_block_2 = ResnetBlock(block_in, block_in, cfg)

        for i in reversed(range(num_res)):
            block_out = cfg.ch * cfg.ch_mult[i]
            skip_in = cfg.ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks + 1):
                if j == cfg.num_res_blocks:
                    skip_in = cfg.ch * in_mult[i]
                self.add_module(f"up_{i}_block_{j}",
                                ResnetBlock(block_in + skip_in, block_out, cfg))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    self.add_module(f"up_{i}_attn_{j}", AttnBlock(block_in, cfg))
            if i != 0:
                if cfg.resamp_with_conv:
                    self.add_module(f"up_{i}_upsample", _conv(block_in, block_in, dt))
                curr_res *= 2

        self.norm_out = Norm(block_in)
        self.conv_out = _conv(block_in, cfg.out_ch, torch.float32)

    def init_random_(self, generator: torch.Generator) -> "DDPMUNet":
        """Seeded random weights (models/base.py::init_random_weights_)."""
        init_random_weights_(self, generator)
        return self

    def forward(self, x, t):
        cfg = self.cfg
        b = x.shape[0]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        t = torch.broadcast_to(t.reshape(-1), (b,))
        temb = self.temb_dense0(ddpm_timestep_embedding(t, cfg.ch))
        temb = self.temb_dense1(F.silu(temb)).to(cfg.dtype)

        h = x.permute(0, 3, 1, 2).to(cfg.dtype)   # NHWC -> channels_last NCHW
        num_res = len(cfg.ch_mult)
        hs = [self.conv_in(h)]
        for i in range(num_res):
            for j in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(hs[-1], temb)
                attn = getattr(self, f"down_{i}_attn_{j}", None)
                if attn is not None:
                    h = attn(h)
                hs.append(h)
            if i != num_res - 1:
                down = getattr(self, f"down_{i}_downsample", None)
                if down is not None:
                    # asymmetric (0, 1, 0, 1) pad + VALID stride-2 conv
                    h = down(F.pad(hs[-1], (0, 1, 0, 1)))
                else:
                    h = F.avg_pool2d(hs[-1], 2)
                hs.append(h)

        h = self.mid_block_1(hs[-1], temb)
        h = self.mid_attn_1(h)
        h = self.mid_block_2(h, temb)

        for i in reversed(range(num_res)):
            for j in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(
                    torch.cat([h, hs.pop()], dim=1), temb)
                attn = getattr(self, f"up_{i}_attn_{j}", None)
                if attn is not None:
                    h = attn(h)
            if i != 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                up = getattr(self, f"up_{i}_upsample", None)
                if up is not None:
                    h = up(h)

        h = F.silu(self.norm_out(h)).to(x.dtype).float()
        return self.conv_out(h).permute(0, 2, 3, 1)   # back to NHWC, f32

"""ADM (guided-diffusion) U-Net as torch modules (port of
loco_edit_tpu/models/adm/unet.py).

Same function and the same parameter names as the Flax model: sinusoidal time
embedding -> MLP; residual blocks with scale-shift GroupNorm conditioning;
self-attention at the configured downsample ratios; skip-concat decoder;
learned-sigma channel split; dropout in the residual blocks where the config
has it, active only in training mode (the JAX package's `train=True`); the
h-space tap and injection at the bottleneck. The public layout is the JAX
package's: images and the bottleneck feature are NHWC (B, H, W, C). Inside, activations are NCHW tensors in
`torch.channels_last` memory (an NHWC array permuted is exactly that), so
cuDNN and the GroupNorm kernel both see channels-contiguous memory.

GroupNorm runs in float32 whatever the compute dtype (ops.group_norm_f32);
convolutions and dense layers hold their weights in cfg.dtype and go to
cuDNN / cuBLAS. Attention goes through ops.sdp_attention.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from loco_edit_tpu_torch.core.device import to_device
from loco_edit_tpu_torch.models.adm.config import (
    ADMConfig,
    ADMLayout,
    AttnSpec,
    ConvSpec,
    ResSpec,
    SampleSpec,
    adm_layout,
)
from loco_edit_tpu_torch.models.base import init_random_weights_
from loco_edit_tpu_torch.ops import Conv2d, group_norm_f32, sdp_attention


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of (possibly fractional) timesteps, [cos|sin]
    ordering. Always float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm(32) computed in f32, params f32, output in input dtype."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return group_norm_f32(x, self.weight, self.bias)


def _conv(in_ch: int, out_ch: int, cfg: ADMConfig, kernel: int = 3,
          stride: int = 1) -> Conv2d:
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2,
                  dtype=cfg.dtype)


def _upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


class ResBlock(nn.Module):
    """Residual block with scale-shift time conditioning and in-block
    up/downsampling."""

    def __init__(self, spec: ResSpec, cfg: ADMConfig):
        super().__init__()
        self.spec, self.cfg = spec, cfg
        self.in_norm = GroupNorm32(spec.in_ch)
        self.in_conv = _conv(spec.in_ch, spec.out_ch, cfg)
        e_dim = 2 * spec.out_ch if cfg.use_scale_shift_norm else spec.out_ch
        self.emb_dense = nn.Linear(cfg.time_embed_dim, e_dim, dtype=cfg.dtype)
        self.out_norm = GroupNorm32(spec.out_ch)
        if cfg.dropout > 0:
            self.dropout = nn.Dropout(cfg.dropout)
        self.out_conv = _conv(spec.out_ch, spec.out_ch, cfg)
        if spec.out_ch != spec.in_ch:
            self.skip_conv = _conv(spec.in_ch, spec.out_ch, cfg, kernel=1)

    def forward(self, x, emb):
        spec = self.spec
        h = F.silu(self.in_norm(x))
        if spec.up:
            h, x = _upsample_nearest(h), _upsample_nearest(x)
        elif spec.down:
            h, x = _avg_pool2(h), _avg_pool2(x)
        h = self.in_conv(h)
        e = self.emb_dense(F.silu(emb))[:, :, None, None].to(h.dtype)
        if self.cfg.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = self.out_norm(h) * (1 + scale) + shift
        else:
            h = self.out_norm(h + e)
        h = F.silu(h)
        if self.cfg.dropout > 0:
            h = self.dropout(h)
        h = self.out_conv(h)
        if spec.out_ch != spec.in_ch:
            x = self.skip_conv(x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over H*W tokens; qkv packed q|k|v."""

    def __init__(self, spec: AttnSpec, cfg: ADMConfig):
        super().__init__()
        self.heads = spec.num_heads
        self.norm = GroupNorm32(spec.ch)
        self.qkv = nn.Linear(spec.ch, 3 * spec.ch, dtype=cfg.dtype)
        self.proj_out = nn.Linear(spec.ch, spec.ch, dtype=cfg.dtype)

    def forward(self, x):
        b, c, hh, ww = x.shape
        n, heads = hh * ww, self.heads
        tokens = self.norm(x).permute(0, 2, 3, 1).reshape(b, n, c)
        q, k, v = self.qkv(tokens).split(c, dim=-1)

        def heads_split(t):
            return t.reshape(b, n, heads, c // heads).transpose(1, 2)

        a = sdp_attention(heads_split(q), heads_split(k), heads_split(v))
        a = self.proj_out(a.transpose(1, 2).reshape(b, n, c))
        return x + a.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class _BlockSeq(nn.Module):
    """One entry of input/middle/output blocks: layers sharing the time
    embedding, named conv_{i} / res_{i} / attn_{i} / sample_{i}."""

    def __init__(self, specs: tuple, cfg: ADMConfig):
        super().__init__()
        self.order = []
        for i, spec in enumerate(specs):
            if isinstance(spec, ConvSpec):
                name, mod = f"conv_{i}", _conv(spec.in_ch, spec.out_ch, cfg)
            elif isinstance(spec, ResSpec):
                name, mod = f"res_{i}", ResBlock(spec, cfg)
            elif isinstance(spec, AttnSpec):
                name, mod = f"attn_{i}", AttentionBlock(spec, cfg)
            elif isinstance(spec, SampleSpec):
                name = f"sample_{i}"
                mod = (_conv(spec.in_ch, spec.out_ch, cfg,
                             stride=1 if spec.up else 2)
                       if spec.use_conv else None)
            else:
                raise TypeError(spec)
            if mod is not None:
                self.add_module(name, mod)
            self.order.append((spec, name))

    def forward(self, h, emb):
        for spec, name in self.order:
            if isinstance(spec, ResSpec):
                h = getattr(self, name)(h, emb)
            elif isinstance(spec, SampleSpec):
                if spec.up:
                    h = _upsample_nearest(h)
                    if spec.use_conv:
                        h = getattr(self, name)(h)
                else:
                    h = getattr(self, name)(h) if spec.use_conv else _avg_pool2(h)
            else:
                h = getattr(self, name)(h)
        return h


class ADMUNet(nn.Module):
    """x: (B, H, W, C) NHWC; t: scalar or (B,) fractional timesteps.

    Returns eps (B, H, W, C_in); with cfg.learn_sigma and return_sigma=True,
    returns (eps, logvar) from the channel split. Dropout follows the
    module's mode: the loaders put models in eval mode.
    """

    def __init__(self, cfg: ADMConfig):
        super().__init__()
        self.cfg = cfg
        self.layout: ADMLayout = adm_layout(cfg)
        for i, specs in enumerate(self.layout.input_blocks):
            self.add_module(f"input_{i}", _BlockSeq(specs, cfg))
        self.middle = _BlockSeq(self.layout.middle_block, cfg)
        for i, specs in enumerate(self.layout.output_blocks):
            self.add_module(f"output_{i}", _BlockSeq(specs, cfg))
        ted = cfg.time_embed_dim
        self.time_dense0 = nn.Linear(cfg.model_channels, ted)
        self.time_dense1 = nn.Linear(ted, ted)
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, ted)
        self.out_norm = GroupNorm32(self.layout.out_ch_final)
        self.out_conv = _conv(self.layout.out_ch_final, cfg.out_channels, cfg)

    def init_random_(self, generator: torch.Generator) -> "ADMUNet":
        """Seeded random weights (models/base.py::init_random_weights_)."""
        init_random_weights_(self, generator)
        return self

    def forward(self, x, t, y=None, *, return_sigma: bool = False,
                return_h: bool = False, h_inject: torch.Tensor | None = None):
        """return_h: also return the mid-block bottleneck feature h_mid, NHWC
        (the reference's h-space tap, get_h); h_inject: an offset added to the
        bottleneck before decoding, any shape holding H*W*C values in (H, W, C)
        order, as the JAX package reads it. Returns out, or with return_h
        (out,) + (h_mid,), out itself a tuple with return_sigma."""
        cfg = self.cfg
        b = x.shape[0]
        t = to_device(t, x.device)
        t = torch.broadcast_to(t.reshape(-1), (b,))
        emb = self.time_dense1(F.silu(self.time_dense0(
            timestep_embedding(t, cfg.model_channels))))
        if cfg.num_classes is not None:
            if y is None:
                y = torch.zeros((b,), dtype=torch.long, device=x.device)
            emb = emb + self.label_emb(y)
        emb = emb.to(cfg.dtype)

        h = x.permute(0, 3, 1, 2).to(cfg.dtype)   # NHWC -> channels_last NCHW
        skips = []
        for i in range(len(self.layout.input_blocks)):
            h = getattr(self, f"input_{i}")(h, emb)
            skips.append(h)
        h = self.middle(h, emb)
        h_mid = h
        if h_inject is not None:
            _, c, hh, ww = h.shape
            h = h + h_inject.reshape(hh, ww, c).permute(2, 0, 1)[None].to(h.dtype)
        for i in range(len(self.layout.output_blocks)):
            h = torch.cat([h, skips.pop()], dim=1)
            h = getattr(self, f"output_{i}")(h, emb)
        h = self.out_conv(F.silu(self.out_norm(h))).to(x.dtype)
        h = h.permute(0, 2, 3, 1)                   # back to NHWC

        if cfg.learn_sigma:
            eps, logvar = h.chunk(2, dim=-1)
            out = (eps, logvar) if return_sigma else eps
        else:
            out = (h, None) if return_sigma else h
        if return_h:
            return (out if isinstance(out, tuple) else (out,)) + (h_mid.permute(0, 2, 3, 1),)
        return out

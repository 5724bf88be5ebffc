"""ADM variants: the super-resolution U-Net and the half-U-Net classifier
encoder (port of loco_edit_tpu/models/adm/variants.py).

Counterparts of the reference's SuperResModel (guided_diffusion/unet.py:
784-799: the low-res conditioning image resized to the model resolution and
concatenated on the channel axis) and EncoderUNetModel (:801-1012: the
encoder trunk and middle block pooled to logits, the classifier of
classifier guidance). Both reuse the ADM block zoo and carry the Flax
parameter names (`unet.` for the wrapped U-Net).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from loco_edit_tpu_torch.models.adm.config import ADMConfig, adm_layout
from loco_edit_tpu_torch.models.adm.unet import (
    ADMUNet,
    GroupNorm32,
    _BlockSeq,
    timestep_embedding,
)


class SuperResADMUNet(nn.Module):
    """eps(x_t, t | low_res), NHWC: the low-res image is resized bilinearly
    to x's resolution and concatenated on channels; cfg.in_channels already
    counts the doubled channels. Resizing matches jax.image.resize's
    "bilinear": half-pixel centres, and a widened (antialiasing) kernel when
    it shrinks."""

    def __init__(self, cfg: ADMConfig):
        super().__init__()
        self.cfg = cfg
        self.unet = ADMUNet(cfg)

    def forward(self, x, t, low_res, **kwargs):
        low = low_res.permute(0, 3, 1, 2)
        up = F.interpolate(low.float(), size=tuple(x.shape[1:3]), mode="bilinear",
                           align_corners=False,
                           antialias=x.shape[1] < low.shape[2] or x.shape[2] < low.shape[3])
        up = up.permute(0, 2, 3, 1).to(x.dtype)
        return self.unet(torch.cat([x, up], dim=-1), t, **kwargs)


@dataclasses.dataclass(frozen=True)
class EncoderHeadConfig:
    pool: str = "adaptive"  # 'adaptive' | 'attention' | 'spatial'
    out_dim: int = 1000


class EncoderADMUNet(nn.Module):
    """Half-U-Net classifier: the ADM encoder trunk and middle block, pooled
    to f32 logits. x: (B, H, W, C) NHWC; t: scalar or (B,)."""

    def __init__(self, cfg: ADMConfig, head: EncoderHeadConfig = EncoderHeadConfig()):
        super().__init__()
        self.cfg, self.head = cfg, head
        self.layout = adm_layout(cfg)
        ted = cfg.time_embed_dim
        self.time_dense0 = nn.Linear(cfg.model_channels, ted)
        self.time_dense1 = nn.Linear(ted, ted)
        for i, specs in enumerate(self.layout.input_blocks):
            self.add_module(f"input_{i}", _BlockSeq(specs, cfg))
        self.middle = _BlockSeq(self.layout.middle_block, cfg)
        ch = self.layout.middle_block[-1].out_ch
        if head.pool == "adaptive":
            self.out_norm = GroupNorm32(ch)
        n_feat = ch
        if head.pool == "spatial":
            side = cfg.image_size // 2 ** (len(cfg.channel_mult) - 1)
            n_feat = side * side * ch
        self.logits = nn.Linear(n_feat, head.out_dim)

    def forward(self, x, t):
        cfg = self.cfg
        b = x.shape[0]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        t = torch.broadcast_to(t.reshape(-1), (b,))
        emb = self.time_dense1(F.silu(self.time_dense0(
            timestep_embedding(t, cfg.model_channels)))).to(cfg.dtype)
        h = x.permute(0, 3, 1, 2).to(cfg.dtype)   # NHWC -> channels_last NCHW
        for i in range(len(self.layout.input_blocks)):
            h = getattr(self, f"input_{i}")(h, emb)
        h = self.middle(h, emb)

        ch = h.shape[1]
        if self.head.pool == "adaptive":
            h = F.silu(self.out_norm(h)).mean(dim=(2, 3))
        else:
            tokens = h.permute(0, 2, 3, 1).reshape(b, -1, ch)   # NHWC order
            if self.head.pool == "spatial":
                h = tokens.reshape(b, -1)
            else:  # attention pool: softmax pooling against the mean token
                q = tokens.mean(dim=1, keepdim=True)
                w = torch.softmax(q @ tokens.transpose(1, 2) / ch ** 0.5, dim=-1)
                h = (w @ tokens)[:, 0]
        return self.logits(h.float())


def classifier_grad_fn(encoder_apply, y):
    """grad_fn(x, t) = grad_x log p(y | x) for classifier guidance (the
    reference's condition_mean), by reverse mode through encoder_apply(x, t)
    -> logits; y: (B,) integer labels."""
    def grad_fn(x, t):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            logp = torch.log_softmax(encoder_apply(xx, t), dim=-1)
            rows = torch.arange(xx.shape[0], device=xx.device)
            total = logp[rows, torch.as_tensor(y, device=xx.device)].sum()
            return torch.autograd.grad(total, xx)[0]

    return grad_fn

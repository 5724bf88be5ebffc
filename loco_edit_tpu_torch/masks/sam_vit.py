"""SAM ViT image encoder (port of loco_edit_tpu/masks/sam_flax.py).

The encoder of transformers' SamVisionEncoder, NHWC at its public surface
as in the JAX package:
  - 16x16 patch conv -> (B, H', W', C) + absolute positional embedding;
  - pre-LN blocks: windowed attention (window 14, zero-pad partition,
    crop back) except the global_attn_indexes layers; the decomposed
    relative-position bias (rel_pos_h/rel_pos_w gathers, built from the
    UNSCALED q) added to f32 logits; exact-erf GELU MLP;
  - neck: 1x1 conv (no bias) -> channel LayerNorm (eps 1e-6) -> 3x3 conv
    (no bias) -> LayerNorm, output (B, H', W', output_channels).

The attention is plain torch (matmul, softmax): the JAX module is an einsum
plus a bias and reaches no Pallas kernel. Submodules carry the Flax names
(`layer_3.attn.qkv`, `neck_ln1`), so `sam_vit_params_from_flax` is a
renaming of layouts only. SAM runs in f32, as in the JAX package
(config_from_hf sets no dtype there).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from loco_edit_tpu_torch.models.convert_util import (KeyTracker, check_state_dict,
                                                     flax_to_state_dict, to_tensor)


@dataclasses.dataclass(frozen=True)
class SamViTConfig:
    """Encoder geometry. `scan_blocks` is accepted for parity with the JAX
    config and ignored: scanning the repeated blocks is an XLA compile-time
    device, and PyTorch runs the layers eagerly either way."""

    image_size: int = 1024
    patch_size: int = 16
    hidden_size: int = 1024            # vit-large
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: tuple[int, ...] = (5, 11, 17, 23)
    output_channels: int = 256
    layer_norm_eps: float = 1e-6
    scan_blocks: bool = False

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


VIT_LARGE = SamViTConfig()
VIT_BASE = SamViTConfig(hidden_size=768, num_layers=12, num_heads=12,
                        global_attn_indexes=(2, 5, 8, 11))
VIT_HUGE = SamViTConfig(hidden_size=1280, num_layers=32, num_heads=16,
                        global_attn_indexes=(7, 15, 23, 31))


def _rel_pos_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(L, d) learned table -> (size, size, d) gathered by relative coords
    (HF get_rel_pos for equal q/k sizes; linear interpolation when the stored
    table length != 2*size-1, with torch F.interpolate(mode="linear",
    align_corners=False) semantics: half-pixel centers, no antialiasing)."""
    max_rel = 2 * size - 1
    dev = rel_pos.device
    if rel_pos.shape[0] != max_rel:
        n = rel_pos.shape[0]
        pos = (torch.arange(max_rel, dtype=torch.float32, device=dev) + 0.5) * (
            n / max_rel) - 0.5
        pos = pos.clamp(0.0, n - 1.0)
        lo = pos.floor().long()
        hi = (lo + 1).clamp(max=n - 1)
        frac = (pos - lo)[:, None]
        rel_pos = rel_pos[lo] * (1 - frac) + rel_pos[hi] * frac
    ar = torch.arange(size, device=dev)
    return rel_pos[ar[:, None] - ar[None, :] + size - 1]


class SamAttention(nn.Module):
    """Multi-head self-attention over a (B, h, w, C) grid with the decomposed
    relative-position bias; `size` is the side of the grid it was trained
    at (the window, or the full grid for a global layer)."""

    def __init__(self, cfg: SamViTConfig, size: int):
        super().__init__()
        c, d = cfg.hidden_size, cfg.hidden_size // cfg.num_heads
        self.heads = cfg.num_heads
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, d))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, d))

    def forward(self, x):
        b, hh, ww, c = x.shape
        heads = self.heads
        d = c // heads
        qkv = self.qkv(x.reshape(b, hh * ww, c))
        qkv = qkv.reshape(b, hh * ww, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]          # (b, heads, n, d)
        logits = torch.matmul((q * d ** -0.5).float(), k.float().transpose(-1, -2))
        rh = _rel_pos_table(self.rel_pos_h, hh).to(q.dtype)
        rw = _rel_pos_table(self.rel_pos_w, ww).to(q.dtype)
        rq = q.reshape(b, heads, hh, ww, d)       # the unscaled q
        bias_h = torch.einsum("bzhwc,hkc->bzhwk", rq, rh)
        bias_w = torch.einsum("bzhwc,wkc->bzhwk", rq, rw)
        bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(
            b, heads, hh * ww, hh * ww)
        w = torch.softmax(logits + bias, dim=-1).to(q.dtype)
        a = torch.matmul(w, v).transpose(1, 2).reshape(b, hh, ww, c)
        return self.proj(a)


class SamVisionLayer(nn.Module):
    def __init__(self, cfg: SamViTConfig, windowed: bool):
        super().__init__()
        c = cfg.hidden_size
        self.windowed, self.window = windowed, cfg.window_size
        self.layer_norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.attn = SamAttention(cfg, cfg.window_size if windowed else cfg.grid)
        self.layer_norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.mlp_lin1 = nn.Linear(c, int(c * cfg.mlp_ratio))
        self.mlp_lin2 = nn.Linear(int(c * cfg.mlp_ratio), c)

    def forward(self, x):
        b, hh, ww, c = x.shape
        h = self.layer_norm1(x)
        if self.windowed:
            w = self.window
            ph, pw = (w - hh % w) % w, (w - ww % w) % w
            h = F.pad(h, (0, 0, 0, pw, 0, ph))
            H, W = hh + ph, ww + pw
            h = h.reshape(b, H // w, w, W // w, w, c).permute(0, 1, 3, 2, 4, 5)
            h = self.attn(h.reshape(-1, w, w, c))
            h = h.reshape(b, H // w, W // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
            h = h.reshape(b, H, W, c)[:, :hh, :ww]
        else:
            h = self.attn(h)
        x = x + h
        h = self.mlp_lin2(F.gelu(self.mlp_lin1(self.layer_norm2(x))))
        return x + h


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SamViTEncoder(nn.Module):
    """pixel_values: (B, image_size, image_size, 3), SAM-normalized.
    Returns (B, grid, grid, output_channels) image embeddings."""

    def __init__(self, cfg: SamViTConfig):
        super().__init__()
        self.cfg = cfg
        c, oc = cfg.hidden_size, cfg.output_channels
        self.patch_embed = nn.Conv2d(3, c, cfg.patch_size, stride=cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid, cfg.grid, c))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", SamVisionLayer(
                cfg, windowed=i not in cfg.global_attn_indexes))
        self.neck_conv1 = nn.Conv2d(c, oc, 1, bias=False)
        self.neck_ln1 = nn.LayerNorm(oc, eps=1e-6)
        self.neck_conv2 = nn.Conv2d(oc, oc, 3, padding=1, bias=False)
        self.neck_ln2 = nn.LayerNorm(oc, eps=1e-6)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator, std: float = 0.02) -> "SamViTEncoder":
        """Seeded weights from HF SamModel's init distribution (hf_init_),
        the rel-pos tables and the positional embedding zero, as HF leaves
        them."""
        hf_init_(self, generator, std)
        for name, p in self.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")) or name == "pos_embed":
                p.zero_()
        return self

    def forward(self, x):
        h = _conv_nhwc(self.patch_embed, x.float()) + self.pos_embed
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"layer_{i}")(h)
        h = self.neck_ln1(_conv_nhwc(self.neck_conv1, h))
        return self.neck_ln2(_conv_nhwc(self.neck_conv2, h))


@torch.no_grad()
def hf_init_(model: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """HF PreTrainedModel._init_weights on every submodule: linear and
    (transposed) conv weights N(0, std), biases 0, LayerNorms (1, 0)."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


# --------------------------------------------------------------- conversion


def _hf_field(hf_cfg, name: str, default=None):
    if isinstance(hf_cfg, Mapping):
        return hf_cfg.get(name, default)
    return getattr(hf_cfg, name, default)


def config_from_hf(hf_cfg) -> SamViTConfig:
    """A SamVisionConfig, or its dict as config.json holds it -> SamViTConfig
    (HF's defaults, vit-base's geometry, where a dict leaves a field out)."""
    f = lambda name, default: _hf_field(hf_cfg, name, default)   # noqa: E731
    return SamViTConfig(
        image_size=f("image_size", 1024), patch_size=f("patch_size", 16),
        hidden_size=f("hidden_size", 768), num_layers=f("num_hidden_layers", 12),
        num_heads=f("num_attention_heads", 12), mlp_ratio=f("mlp_ratio", 4.0),
        window_size=f("window_size", 14),
        global_attn_indexes=tuple(f("global_attn_indexes", (2, 5, 8, 11))),
        output_channels=f("output_channels", 256),
        layer_norm_eps=f("layer_norm_eps", 1e-6))


def convert_sam_vision_state_dict(sd: Mapping, cfg: SamViTConfig) -> dict[str, torch.Tensor]:
    """HF SamModel (or SamVisionModel) state_dict -> SamViTEncoder
    state_dict (f32 CPU tensors). Accepts keys with or without the
    `vision_encoder.` prefix; prompt-encoder / mask-decoder keys are
    ignored (masks/sam_decoder.py converts them). Every vision key must be
    consumed and the result must match the module tree of `cfg`."""
    sd = {k.removeprefix("vision_encoder."): v for k, v in sd.items()
          if not k.startswith(("prompt_encoder.", "mask_decoder.",
                               "shared_image_embedding."))}
    tr = KeyTracker(sd)
    out: dict[str, torch.Tensor] = {}

    def copy(src: str, dst: str, bias: bool = True):
        out[f"{dst}.weight"] = to_tensor(tr[f"{src}.weight"])
        if bias:
            out[f"{dst}.bias"] = to_tensor(tr[f"{src}.bias"])

    copy("patch_embed.projection", "patch_embed")
    out["pos_embed"] = to_tensor(tr["pos_embed"])
    copy("neck.conv1", "neck_conv1", bias=False)
    copy("neck.layer_norm1", "neck_ln1")
    copy("neck.conv2", "neck_conv2", bias=False)
    copy("neck.layer_norm2", "neck_ln2")
    for i in range(cfg.num_layers):
        s, d = f"layers.{i}", f"layer_{i}"
        for name in ("layer_norm1", "layer_norm2", "attn.qkv", "attn.proj"):
            copy(f"{s}.{name}", f"{d}.{name}")
        copy(f"{s}.mlp.lin1", f"{d}.mlp_lin1")
        copy(f"{s}.mlp.lin2", f"{d}.mlp_lin2")
        for name in ("rel_pos_h", "rel_pos_w"):
            out[f"{d}.attn.{name}"] = to_tensor(tr[f"{s}.attn.{name}"])
    tr.check("SAM vision encoder")
    with torch.device("meta"):
        check_state_dict(out, SamViTEncoder(cfg), "SAM vision weights")
    return out


_RAW_LEAVES = ("rel_pos_h", "rel_pos_w", "pos_embed")


def sam_vit_params_from_flax(flat: Mapping[str, np.ndarray],
                             cfg: SamViTConfig) -> dict[str, torch.Tensor]:
    """Carry a flat Flax SamViTEncoder parameter dict ("params/layer_0/attn/
    qkv/kernel" style keys, unrolled layers) to a SamViTEncoder state_dict:
    Dense and Conv kernels change layout, LayerNorm scales become weights,
    the rel-pos tables and the positional embedding keep theirs."""
    raw = {k: v for k, v in flat.items() if k.rsplit("/", 1)[-1] in _RAW_LEAVES}
    sd = flax_to_state_dict({k: v for k, v in flat.items() if k not in raw})
    for key, arr in raw.items():
        parts = key.split("/")
        sd[".".join(parts[1:] if parts[0] == "params" else parts)] = to_tensor(arr)
    with torch.device("meta"):
        check_state_dict(sd, SamViTEncoder(cfg), "Flax SAM encoder params")
    return sd

"""Stable-Diffusion-family configs (port of loco_edit_tpu/models/sd/config.py).

SD 2.1-base, SD 1.5, LCM Dreamshaper v7 (SD 1.5 with a guidance-scale
embedding) and a tiny test preset, with torch compute dtypes. The port runs
`sd21-base` and `tiny`; `sd15` and the LCM preset use 8 heads per level
(head dims 40/80/160), which the attention kernel does not take yet.

`remat` is the JAX package's per-block checkpointing switch: it does not
compose with torch.func's jvp and vmap, so the port's modules raise
NotImplementedError when it is set.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: tuple[int, ...] = (5, 10, 20, 20)  # heads per level
    transformer_layers: int = 1
    use_linear_projection: bool = True   # SD 2.x; SD 1.x uses 1x1 convs
    # levels with cross-attention transformers (SD: all but the last down /
    # first up level)
    cross_attn_levels: tuple[bool, ...] = (True, True, True, False)
    time_cond_proj_dim: int | None = None  # LCM guidance-embedding input dim
    dtype: torch.dtype = torch.float32
    remat: bool = False   # refused by the modules (see the module docstring)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    sample_size: int = 512
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.float32
    remat: bool = False


_PRESETS = {
    # stabilityai/stable-diffusion-2-1-base
    "sd21-base": SDUNetConfig(),
    # runwayml/stable-diffusion-v1-5 (also the LCM Dreamshaper v7 backbone)
    "sd15": SDUNetConfig(
        cross_attention_dim=768,
        attention_head_dim=(8, 8, 8, 8),
        use_linear_projection=False,
    ),
    # SimianLuo/LCM_Dreamshaper_v7: SD 1.5 + guidance-scale embedding
    "lcm-dreamshaper-v7": SDUNetConfig(
        cross_attention_dim=768,
        attention_head_dim=(8, 8, 8, 8),
        use_linear_projection=False,
        time_cond_proj_dim=256,
    ),
    # tiny CPU-test config (all block types exercised)
    "tiny": SDUNetConfig(
        sample_size=8,
        block_out_channels=(32, 64),
        layers_per_block=1,
        cross_attention_dim=32,
        attention_head_dim=(2, 4),
        cross_attn_levels=(True, False),
    ),
}


def sd_preset(name: str, dtype: torch.dtype = torch.float32) -> SDUNetConfig:
    if name not in _PRESETS:
        raise ValueError(f"unknown SD preset {name!r}; have {sorted(_PRESETS)}")
    return dataclasses.replace(_PRESETS[name], dtype=dtype)


def check_no_remat(cfg, what: str) -> None:
    """Raise for cfg.remat: the port keeps every activation (ROADMAP.md
    records why; the 80 GB card holds the rank-5+5 basis without it)."""
    if cfg.remat:
        raise NotImplementedError(
            f"{what}: remat (per-block checkpointing) does not compose with "
            "torch.func jvp/vmap and is not ported (ROADMAP.md Queue A item 10, "
            "decided)")

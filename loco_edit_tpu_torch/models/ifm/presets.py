"""DeepFloyd-IF presets (port of loco_edit_tpu/models/ifm/presets.py).

What every published IF config shares (diffusers UNet2DConditionModel):
exact-erf GELU, cross_attention_norm "group_norm", attention_head_dim 64,
addition_embed_type "text" with 64 pooling heads, T5-XXL conditioning
(encoder_hid_dim 4096), learned sigma (out = 2 x 3); stage 1 at 64 px with
attention below the first level; stage 2 at 256 px, in_channels 6
(channel-concat cascade conditioning), class_embed_type "timestep" for the
aug level, attention only at the deepest level.

The geometry of each size tier is the JAX package's, calibrated there
against the advertised parameter counts (IF-I-M 400M, IF-I-L 900M, IF-I-XL
4.3B, IF-II-M 450M, IF-II-L 1.2B). Presets only seed random-weight runs
and tests: a real checkpoint's geometry comes from its shapes
(models/ifm/convert.py::infer_if_config).
"""

from __future__ import annotations

import torch

from loco_edit_tpu_torch.models.ifm.unet import IFUNetConfig

_STAGE1 = dict(
    sample_size=64, in_channels=3, out_channels=6,
    attn_levels=(False, True, True, True),
    act_fn="gelu", cross_attention_norm="group_norm",
    use_addition_text_embed=True, addition_embed_num_heads=64,
    attention_head_dim=64, encoder_hid_dim=4096,
)
_STAGE2 = dict(
    sample_size=256, in_channels=6, out_channels=6,
    attn_levels=(False, False, False, True),
    act_fn="gelu", cross_attention_norm="group_norm",
    use_addition_text_embed=True, addition_embed_num_heads=64,
    attention_head_dim=64, encoder_hid_dim=4096,
    class_embed_timestep=True,
)

_PRESETS = {
    "IF-I-M": dict(block_out_channels=(128, 256, 512, 1024),
                   layers_per_block=3, cross_attention_dim=512, **_STAGE1),
    "IF-I-L": dict(block_out_channels=(192, 384, 768, 1536),
                   layers_per_block=3, cross_attention_dim=768, **_STAGE1),
    "IF-I-XL": dict(block_out_channels=(384, 768, 1536, 3072),
                    layers_per_block=4, cross_attention_dim=1536, **_STAGE1),
    "IF-II-M": dict(block_out_channels=(128, 256, 512, 1024),
                    layers_per_block=3, cross_attention_dim=512, **_STAGE2),
    "IF-II-L": dict(block_out_channels=(256, 512, 1024, 2048),
                    layers_per_block=2, cross_attention_dim=1024, **_STAGE2),
}


def if_preset(name: str, dtype: torch.dtype = torch.float32) -> IFUNetConfig:
    """name: 'IF-I-M' | 'IF-I-L' | 'IF-I-XL' | 'IF-II-M' | 'IF-II-L', or the
    hub-style 'DeepFloyd/IF-I-M-v1.0' form the reference scripts use."""
    key = name.split("/")[-1]
    for suffix in ("-v1.0", "-v1.1"):
        key = key.removesuffix(suffix)
    if key not in _PRESETS:
        raise ValueError(f"unknown IF preset {name!r}; have {sorted(_PRESETS)}")
    return IFUNetConfig(dtype=dtype, **_PRESETS[key])


def tiny_if_config(stage2: bool = False, dtype: torch.dtype = torch.float32) -> IFUNetConfig:
    """A CPU-testable miniature with every IF feature (GELU, group-norm
    cross norm, addition embedding, the stage-2 class embedding)."""
    return IFUNetConfig(
        sample_size=32 if stage2 else 16,
        in_channels=6 if stage2 else 3, out_channels=6,
        block_out_channels=(32, 64), layers_per_block=(1, 2),
        encoder_hid_dim=48, cross_attention_dim=32, attention_head_dim=16,
        attn_levels=(False, True), act_fn="gelu",
        cross_attention_norm="group_norm", use_addition_text_embed=True,
        addition_embed_num_heads=4, class_embed_timestep=stage2, dtype=dtype)

"""diffusers DeepFloyd-IF checkpoints -> the port's IFUNet state_dicts, with
the geometry recovered from the shapes (port of
loco_edit_tpu/models/ifm/convert.py), and the Flax-parameter carry.

  - `infer_if_config(sd)`: block widths, per-level layer counts, attention
    placement, conditioning widths, the stage-2 class embedding and the
    addition text embedding, from the state_dict's shapes, so a real
    checkpoint loads whatever the presets say.
  - `convert_if_state_dict(sd, cfg)`: the port's modules carry the Flax
    names (`down_1_attn_0.add_k_proj`) in torch layouts, so each of the
    model's keys is mapped to its diffusers key (the renaming of
    models/sd/convert.py); with strict=True every checkpoint key must be
    consumed, and the result is held to the module tree.
  - `if_params_from_flax(flat, cfg)`: a flat Flax IFUNet parameter dict
    (the JAX package's) to the port's state_dict.
"""

from __future__ import annotations

import math
import re
from typing import Mapping

import numpy as np
import torch

from loco_edit_tpu_torch.models.convert_util import (KeyTracker, check_state_dict,
                                                     flax_to_state_dict)
from loco_edit_tpu_torch.models.ifm.unet import IFUNet, IFUNetConfig
from loco_edit_tpu_torch.models.sd.convert import _convert


def _if_rules(cfg: IFUNetConfig):
    n = len(cfg.block_out_channels)
    up = lambda m: str(n - 1 - int(m.group(1)))   # noqa: E731
    return (
        (r"^time_dense0\.", "time_embedding.linear_1."),
        (r"^time_dense1\.", "time_embedding.linear_2."),
        (r"^class_dense0\.", "class_embedding.linear_1."),
        (r"^class_dense1\.", "class_embedding.linear_2."),
        (r"^add_embedding\.(q_proj|k_proj|v_proj|positional_embedding)",
         r"add_embedding.pool.\1"),
        (r"^down_(\d+)_res_(\d+)\.", r"down_blocks.\1.resnets.\2."),
        (r"^down_(\d+)_attn_(\d+)\.", r"down_blocks.\1.attentions.\2."),
        (r"^down_(\d+)_downsample\.", r"down_blocks.\1.downsamplers.0."),
        (r"^mid_res_(\d+)\.", r"mid_block.resnets.\1."),
        (r"^mid_attn\.", "mid_block.attentions.0."),
        (r"^up_(\d+)_res_(\d+)\.",
         lambda m: f"up_blocks.{up(m)}.resnets.{m.group(2)}."),
        (r"^up_(\d+)_attn_(\d+)\.",
         lambda m: f"up_blocks.{up(m)}.attentions.{m.group(2)}."),
        (r"^up_(\d+)_upsample\.", lambda m: f"up_blocks.{up(m)}.upsamplers.0."),
    )


def _shape(sd, key) -> tuple[int, ...]:
    return tuple(int(s) for s in sd[key].shape)


def infer_if_config(sd: Mapping, *, sample_size: int | None = None,
                    attention_head_dim: int = 64,
                    dtype: torch.dtype = torch.float32) -> IFUNetConfig:
    """Recover the U-Net geometry from checkpoint shapes. attention_head_dim
    (64 in every published IF config), act_fn and cross_attention_norm
    ("gelu", "group_norm" in every published IF config) are not in the
    shapes and take the IF values."""
    n = 1 + max(int(m.group(1)) for k in sd
                if (m := re.match(r"down_blocks\.(\d+)\.", k)))
    block_out, layers, attn_levels = [], [], []
    for i in range(n):
        block_out.append(_shape(sd, f"down_blocks.{i}.resnets.0.conv1.weight")[0])
        layers.append(1 + max(int(m.group(1)) for k in sd
                              if (m := re.match(rf"down_blocks\.{i}\.resnets\.(\d+)\.", k))))
        attn_levels.append(f"down_blocks.{i}.attentions.0.to_q.weight" in sd)
    xdim, ehid = _shape(sd, "encoder_hid_proj.weight")
    has_class = "class_embedding.linear_1.weight" in sd
    if sample_size is None:
        # stage 2 (the aug-level class embedding) renders at 256 px
        sample_size = 256 if has_class else 64
    return IFUNetConfig(
        sample_size=sample_size,
        in_channels=_shape(sd, "conv_in.weight")[1],
        out_channels=_shape(sd, "conv_out.weight")[0],
        block_out_channels=tuple(block_out),
        layers_per_block=tuple(layers),
        encoder_hid_dim=ehid,
        cross_attention_dim=xdim,
        attention_head_dim=attention_head_dim,
        attn_levels=tuple(attn_levels),
        act_fn="gelu",
        cross_attention_norm="group_norm",
        use_addition_text_embed="add_embedding.proj.weight" in sd,
        # every published IF config pools with 64 heads (encoder_hid_dim
        # 4096); the gcd keeps tiny synthetic checkpoints valid
        addition_embed_num_heads=64 if ehid % 64 == 0 else math.gcd(ehid, 64),
        class_embed_timestep=has_class,
        dtype=dtype)


def convert_if_state_dict(sd: Mapping, cfg: IFUNetConfig,
                          strict: bool = True) -> dict[str, torch.Tensor]:
    """A diffusers UNet2DConditionModel (IF) state_dict -> an IFUNet
    state_dict; with strict=True every checkpoint key must be consumed."""
    tracker = KeyTracker(sd)
    with torch.device("meta"):
        model = IFUNet(cfg)
    out = _convert(sd, model, _if_rules(cfg), "IF UNet checkpoint", tracker)
    if strict:
        tracker.check("IF UNet")
    return out


def if_params_from_flax(flat: Mapping[str, np.ndarray],
                        cfg: IFUNetConfig) -> dict[str, torch.Tensor]:
    """Carry a flat Flax IFUNet parameter dict to an IFUNet state_dict (the
    names agree; LayerNorm and GroupNorm `scale` become `weight`). Raises
    ValueError unless it matches the module tree of cfg."""
    sd = flax_to_state_dict(flat)
    with torch.device("meta"):
        check_state_dict(sd, IFUNet(cfg), "Flax IF UNet params")
    return sd

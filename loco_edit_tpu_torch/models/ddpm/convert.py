"""Checkpoint converters for the classic DDPM U-Net (port of
loco_edit_tpu/models/ddpm/convert.py).

Two source namings map onto the port's DDPMUNet state_dict (the Flax names
in torch layouts):
  - SDEdit / original DDPM naming (temb.dense.*, down.{i}.block.{j}, ...),
    the reference's YAML-configured `DDPM`;
  - diffusers UNet2DModel naming (time_embedding.linear_*, down_blocks...,
    attention as Linear q/k/v), the HF `google/ddpm-ema-*` checkpoints the
    *_HF names load. diffusers orders up_blocks deepest-first, the original
    orders up.{i} shallowest-first.
Attention q/k/v/proj_out may be 1x1 convolutions (SDEdit) or Linear layers
(diffusers); both become Linear weights (C, C).
"""

from __future__ import annotations

from typing import Mapping

import torch

from loco_edit_tpu_torch.models.convert_util import copy_param
from loco_edit_tpu_torch.models.ddpm.unet import DDPMConfig

_RES = ("norm1", "conv1", "temb_proj", "norm2", "conv2")
_ATTN = ("norm", "q", "k", "v", "proj_out")


def _res(sd, src: str, dst: str, out: dict, temb: str = "temb_proj",
         shortcut: str = "nin_shortcut") -> None:
    for name, ours in zip(("norm1", "conv1", temb, "norm2", "conv2"), _RES):
        copy_param(sd, f"{src}.{name}", out, f"{dst}.{ours}")
    if f"{src}.{shortcut}.weight" in sd:
        copy_param(sd, f"{src}.{shortcut}", out, f"{dst}.nin_shortcut")


def _attn(sd, src: str, dst: str, out: dict, names=_ATTN) -> None:
    copy_param(sd, f"{src}.{names[0]}", out, f"{dst}.norm")
    for name, ours in zip(names[1:], _ATTN[1:]):
        copy_param(sd, f"{src}.{name}", out, f"{dst}.{ours}", as_linear=True)


def convert_ddpm_state_dict(sd: Mapping, cfg: DDPMConfig) -> dict[str, torch.Tensor]:
    """SDEdit/original DDPM naming -> DDPMUNet state_dict."""
    out: dict = {}
    copy_param(sd, "temb.dense.0", out, "temb_dense0")
    copy_param(sd, "temb.dense.1", out, "temb_dense1")
    for name in ("conv_in", "norm_out", "conv_out"):
        copy_param(sd, name, out, name)
    _res(sd, "mid.block_1", "mid_block_1", out)
    _attn(sd, "mid.attn_1", "mid_attn_1", out)
    _res(sd, "mid.block_2", "mid_block_2", out)
    num_res = len(cfg.ch_mult)
    curr_res = cfg.resolution
    for i in range(num_res):
        for j in range(cfg.num_res_blocks):
            _res(sd, f"down.{i}.block.{j}", f"down_{i}_block_{j}", out)
            if curr_res in cfg.attn_resolutions:
                _attn(sd, f"down.{i}.attn.{j}", f"down_{i}_attn_{j}", out)
        if i != num_res - 1:
            if cfg.resamp_with_conv:
                copy_param(sd, f"down.{i}.downsample.conv", out, f"down_{i}_downsample")
            curr_res //= 2
    for i in reversed(range(num_res)):
        for j in range(cfg.num_res_blocks + 1):
            _res(sd, f"up.{i}.block.{j}", f"up_{i}_block_{j}", out)
            if curr_res in cfg.attn_resolutions:
                _attn(sd, f"up.{i}.attn.{j}", f"up_{i}_attn_{j}", out)
        if i != 0:
            if cfg.resamp_with_conv:
                copy_param(sd, f"up.{i}.upsample.conv", out, f"up_{i}_upsample")
            curr_res *= 2
    return out


def convert_diffusers_unet2d_state_dict(sd: Mapping,
                                        cfg: DDPMConfig) -> dict[str, torch.Tensor]:
    """diffusers UNet2DModel naming -> DDPMUNet state_dict (the old
    `query/key/value` and the new `to_q/to_k/to_v/to_out.0` attention
    namings both handled)."""
    def attn(src, dst):
        if f"{src}.query.weight" in sd:
            names = ("group_norm", "query", "key", "value", "proj_attn")
        else:
            names = ("group_norm", "to_q", "to_k", "to_v", "to_out.0")
        _attn(sd, src, dst, out, names)

    def res(src, dst):
        _res(sd, src, dst, out, temb="time_emb_proj", shortcut="conv_shortcut")

    out: dict = {}
    copy_param(sd, "time_embedding.linear_1", out, "temb_dense0")
    copy_param(sd, "time_embedding.linear_2", out, "temb_dense1")
    copy_param(sd, "conv_in", out, "conv_in")
    copy_param(sd, "conv_norm_out", out, "norm_out")
    copy_param(sd, "conv_out", out, "conv_out")
    res("mid_block.resnets.0", "mid_block_1")
    attn("mid_block.attentions.0", "mid_attn_1")
    res("mid_block.resnets.1", "mid_block_2")

    num_res = len(cfg.ch_mult)
    curr_res = cfg.resolution
    for i in range(num_res):
        for j in range(cfg.num_res_blocks):
            res(f"down_blocks.{i}.resnets.{j}", f"down_{i}_block_{j}")
            if curr_res in cfg.attn_resolutions:
                attn(f"down_blocks.{i}.attentions.{j}", f"down_{i}_attn_{j}")
        if i != num_res - 1:
            if cfg.resamp_with_conv:
                copy_param(sd, f"down_blocks.{i}.downsamplers.0.conv", out,
                           f"down_{i}_downsample")
            curr_res //= 2
    # diffusers up_blocks.k == original level num_res - 1 - k
    for k in range(num_res):
        i = num_res - 1 - k
        level_res = cfg.resolution // (2 ** i)
        for j in range(cfg.num_res_blocks + 1):
            res(f"up_blocks.{k}.resnets.{j}", f"up_{i}_block_{j}")
            if level_res in cfg.attn_resolutions:
                attn(f"up_blocks.{k}.attentions.{j}", f"up_{i}_attn_{j}")
        if i != 0 and cfg.resamp_with_conv:
            copy_param(sd, f"up_blocks.{k}.upsamplers.0.conv", out, f"up_{i}_upsample")
    return out

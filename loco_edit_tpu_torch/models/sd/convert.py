"""diffusers SD checkpoints -> the port's state_dicts (port of
loco_edit_tpu/models/sd/convert.py): UNet2DConditionModel and
AutoencoderKL, plus the Flax-parameter carry for both.

The port's modules carry the Flax names (`down_0_res_0.conv1`,
`mid_attn.block_0.attn2.to_out_0`) in torch layouts, so a diffusers
checkpoint only needs renaming: each of the model's keys is mapped to its
diffusers key, and 1x1 convolutions used as Linear layers (the old VAE
attention's query/key/value/proj_attn) are squeezed. Both VAE attention
namings (to_q/to_k/to_v/to_out.0 and query/key/value/proj_attn) and both
transformer projections (linear, SD 2.x; 1x1 conv, SD 1.x) are taken. With
strict=True every checkpoint key must be consumed; the result is held to the
module tree key for key and shape for shape (convert_util.check_state_dict).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from loco_edit_tpu_torch.models.convert_util import (
    KeyTracker,
    check_state_dict,
    flax_to_state_dict,
    to_tensor,
)
from loco_edit_tpu_torch.models.sd.config import SDUNetConfig, VAEConfig

# inside a block: the port's (Flax) name -> diffusers' name
_INNER = ((r"\.block_(\d+)\.", r".transformer_blocks.\1."),
          (r"\.to_out_0\.", ".to_out.0."),
          (r"\.ff_net_0\.", ".ff.net.0."),
          (r"\.ff_net_2\.", ".ff.net.2."))


def _rename(key: str, rules) -> str:
    """The diffusers name of one of the port's keys: the first rule whose
    pattern matches renames the module prefix, then the inner names."""
    for pat, rep in rules:
        key, n = re.subn(pat, rep, key)
        if n:
            break
    for pat, rep in _INNER:
        key = re.sub(pat, rep, key)
    return key


def _unet_rules(cfg: SDUNetConfig):
    n = len(cfg.block_out_channels)
    up = lambda m: str(n - 1 - int(m.group(1)))   # noqa: E731
    return (
        (r"^time_dense0\.", "time_embedding.linear_1."),
        (r"^time_dense1\.", "time_embedding.linear_2."),
        (r"^cond_proj\.", "time_embedding.cond_proj."),
        (r"^down_(\d+)_res_(\d+)\.", r"down_blocks.\1.resnets.\2."),
        (r"^down_(\d+)_attn_(\d+)\.", r"down_blocks.\1.attentions.\2."),
        (r"^down_(\d+)_downsample\.", r"down_blocks.\1.downsamplers.0.conv."),
        (r"^mid_res_(\d+)\.", r"mid_block.resnets.\1."),
        (r"^mid_attn\.", "mid_block.attentions.0."),
        (r"^up_(\d+)_res_(\d+)\.",
         lambda m: f"up_blocks.{up(m)}.resnets.{m.group(2)}."),
        (r"^up_(\d+)_attn_(\d+)\.",
         lambda m: f"up_blocks.{up(m)}.attentions.{m.group(2)}."),
        (r"^up_(\d+)_upsample\.", lambda m: f"up_blocks.{up(m)}.upsamplers.0.conv."),
    )


def _vae_rules(cfg: VAEConfig, part: str, old_attn: bool):
    n = len(cfg.block_out_channels)
    up = lambda m: str(n - 1 - int(m.group(1)))   # noqa: E731
    p = f"{part}."
    rules = [
        (r"^quant_conv\.", "quant_conv."),
        (r"^post_quant_conv\.", "post_quant_conv."),
        (r"^down_(\d+)_res_(\d+)\.", p + r"down_blocks.\1.resnets.\2."),
        (r"^down_(\d+)_downsample\.", p + r"down_blocks.\1.downsamplers.0.conv."),
        (r"^up_(\d+)_res_(\d+)\.", lambda m: f"{p}up_blocks.{up(m)}.resnets.{m.group(2)}."),
        (r"^up_(\d+)_upsample\.", lambda m: f"{p}up_blocks.{up(m)}.upsamplers.0.conv."),
        (r"^mid_res_(\d+)\.", p + r"mid_block.resnets.\1."),
    ]
    if old_attn:
        rules += [(rf"^mid_attn\.{ours}\.", f"{p}mid_block.attentions.0.{theirs}.")
                  for ours, theirs in (("to_q", "query"), ("to_k", "key"),
                                       ("to_v", "value"), ("to_out_0", "proj_attn"))]
    rules += [(r"^mid_attn\.", p + "mid_block.attentions.0."),
              (r"^(conv_in|conv_norm_out|conv_out)\.", p + r"\1.")]
    return tuple(rules)


def _convert(sd: Mapping, model: torch.nn.Module, rules, what: str,
             tracker: KeyTracker) -> dict[str, torch.Tensor]:
    out = {}
    for key, ref in model.state_dict().items():
        out[key] = to_tensor(tracker[_rename(key, rules)]).reshape(ref.shape)
    check_state_dict(out, model, what)
    return out


def convert_sd_unet_state_dict(sd: Mapping, cfg: SDUNetConfig,
                               strict: bool = True) -> dict[str, torch.Tensor]:
    """A diffusers UNet2DConditionModel state_dict -> an SDUNet state_dict."""
    from loco_edit_tpu_torch.models.sd.unet import SDUNet

    tracker = KeyTracker(sd)
    with torch.device("meta"):
        model = SDUNet(cfg)
    out = _convert(sd, model, _unet_rules(cfg), "SD UNet checkpoint", tracker)
    if strict:
        tracker.check("SD UNet")
    return out


def convert_vae_state_dict(sd: Mapping, cfg: VAEConfig, strict: bool = True
                           ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """A diffusers AutoencoderKL state_dict -> (VAEEncoder, VAEDecoder)
    state_dicts."""
    from loco_edit_tpu_torch.models.sd.vae import VAEDecoder, VAEEncoder

    tracker = KeyTracker(sd)
    old = "encoder.mid_block.attentions.0.to_q.weight" not in sd
    with torch.device("meta"):
        enc, dec = VAEEncoder(cfg), VAEDecoder(cfg)
    pe = _convert(sd, enc, _vae_rules(cfg, "encoder", old), "VAE encoder checkpoint",
                  tracker)
    pd = _convert(sd, dec, _vae_rules(cfg, "decoder", old), "VAE decoder checkpoint",
                  tracker)
    if strict:
        tracker.check("VAE")
    return pe, pd


def sd_params_from_flax(flat: Mapping[str, np.ndarray],
                        cfg: SDUNetConfig) -> dict[str, torch.Tensor]:
    """Carry a flat Flax SDUNet parameter dict to an SDUNet state_dict; the
    names already agree (LayerNorm `scale` becomes `weight`, as GroupNorm's
    does). Raises ValueError unless it matches the module tree of cfg."""
    from loco_edit_tpu_torch.models.sd.unet import SDUNet

    sd = flax_to_state_dict(flat)
    with torch.device("meta"):
        check_state_dict(sd, SDUNet(cfg), "Flax SD UNet params")
    return sd


def vae_params_from_flax(flat_enc: Mapping[str, np.ndarray],
                         flat_dec: Mapping[str, np.ndarray], cfg: VAEConfig
                         ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Carry flat Flax VAEEncoder / VAEDecoder parameter dicts to the port's
    state_dicts, checked against the module trees of cfg."""
    from loco_edit_tpu_torch.models.sd.vae import VAEDecoder, VAEEncoder

    pe, pd = flax_to_state_dict(flat_enc), flax_to_state_dict(flat_dec)
    with torch.device("meta"):
        check_state_dict(pe, VAEEncoder(cfg), "Flax VAE encoder params")
        check_state_dict(pd, VAEDecoder(cfg), "Flax VAE decoder params")
    return pe, pd

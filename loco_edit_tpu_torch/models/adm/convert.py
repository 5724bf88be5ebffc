"""torch ADM checkpoint -> the port's ADMUNet state_dict (port of
loco_edit_tpu/models/adm/convert.py).

Maps guided-diffusion UNetModel state_dicts (the P2/LSUN/ImageNet
checkpoints) onto the module tree built from the same `adm_layout`. The
layouts already agree except in two places:

  torch Conv1d (O, I, 1)      -> Linear weight (O, I)
  qkv conv1d, legacy packing  -> Linear with q|k|v-contiguous rows: the
    legacy ADM attention packs channels per head [h0:(q,k,v), h1:(q,k,v),
    ...]; the port's attention splits [q:(h0..hH), k:(...), v:(...)], so
    the output channels are permuted.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from loco_edit_tpu_torch.models.adm.config import (
    ADMConfig,
    AttnSpec,
    ConvSpec,
    ResSpec,
    SampleSpec,
    adm_layout,
)
from loco_edit_tpu_torch.models.convert_util import copy_param, to_tensor


def _qkv_legacy_perm(c: int, heads: int) -> np.ndarray:
    """Row order that takes legacy head-interleaved qkv channels, output
    channel (h, p, j) at h*3d + p*d + j, to q|k|v-contiguous ones at
    p*C + h*d + j."""
    d = c // heads
    perm = np.empty(3 * c, np.int64)
    for p in range(3):
        for h in range(heads):
            src = h * 3 * d + p * d
            dst = p * c + h * d
            perm[dst:dst + d] = np.arange(src, src + d)
    return perm


def _attn(sd, src: str, dst: str, out: dict, heads: int, new_order: bool) -> None:
    w = to_tensor(sd[f"{src}.qkv.weight"])
    w = w.reshape(w.shape[0], w.shape[1])               # (3C, C, 1) -> (3C, C)
    b = to_tensor(sd[f"{src}.qkv.bias"])
    if w.shape[0] != 3 * w.shape[1]:
        raise ValueError(f"{src}.qkv.weight: expected (3C, C, 1), got {tuple(w.shape)}")
    if not new_order:
        perm = torch.from_numpy(_qkv_legacy_perm(w.shape[1], heads))
        w, b = w[perm], b[perm]
    out[f"{dst}.qkv.weight"], out[f"{dst}.qkv.bias"] = w, b
    copy_param(sd, f"{src}.norm", out, f"{dst}.norm")
    copy_param(sd, f"{src}.proj_out", out, f"{dst}.proj_out", as_linear=True)


def _res(sd, src: str, dst: str, out: dict, spec: ResSpec) -> None:
    for name, ours in (("in_layers.0", "in_norm"), ("in_layers.2", "in_conv"),
                       ("emb_layers.1", "emb_dense"), ("out_layers.0", "out_norm"),
                       ("out_layers.3", "out_conv")):
        copy_param(sd, f"{src}.{name}", out, f"{dst}.{ours}")
    if spec.out_ch != spec.in_ch:
        copy_param(sd, f"{src}.skip_connection", out, f"{dst}.skip_conv")


def convert_adm_state_dict(sd: Mapping, cfg: ADMConfig,
                           use_new_attention_order: bool = False) -> dict[str, torch.Tensor]:
    """The ADMUNet(cfg) state_dict from a torch guided-diffusion state_dict."""
    layout = adm_layout(cfg)
    out: dict = {}
    copy_param(sd, "time_embed.0", out, "time_dense0")
    copy_param(sd, "time_embed.2", out, "time_dense1")
    if cfg.num_classes is not None:
        out["label_emb.weight"] = to_tensor(sd["label_emb.weight"])

    def seq(src: str, specs, dst: str):
        for j, spec in enumerate(specs):
            t = f"{src}.{j}"
            if isinstance(spec, ConvSpec):
                copy_param(sd, t, out, f"{dst}.conv_{j}")
            elif isinstance(spec, ResSpec):
                _res(sd, t, f"{dst}.res_{j}", out, spec)
            elif isinstance(spec, AttnSpec):
                _attn(sd, t, f"{dst}.attn_{j}", out, spec.num_heads,
                      use_new_attention_order)
            elif isinstance(spec, SampleSpec):
                if spec.use_conv:
                    copy_param(sd, f"{t}.conv" if spec.up else f"{t}.op", out,
                               f"{dst}.sample_{j}")
            else:
                raise TypeError(spec)

    for i, specs in enumerate(layout.input_blocks):
        seq(f"input_blocks.{i}", specs, f"input_{i}")
    seq("middle_block", layout.middle_block, "middle")
    for i, specs in enumerate(layout.output_blocks):
        seq(f"output_blocks.{i}", specs, f"output_{i}")
    copy_param(sd, "out.0", out, "out_norm")
    copy_param(sd, "out.2", out, "out_conv")
    return out


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a .pt/.pth/.bin/.ckpt (torch pickle, tensors only) or a
    .safetensors state_dict into f32 CPU tensors. A .safetensors file needs
    the safetensors package."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(f"{path}: reading .safetensors needs the "
                               "safetensors package") from e
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float() for k, v in sd.items()}

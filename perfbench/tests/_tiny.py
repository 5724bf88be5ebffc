"""Tiny cells for the CPU tests: the served TinyTest ADM (32 px) and the
tiny LCM U-Net with a 64 px VAE, at sizes a test run holds, with the cell
configurations' limits."""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import manifest  # noqa: E402


def _load(path):
    with open(os.path.join(ROOT, "perfbench", path)) as f:
        return json.load(f)


def p2_cell(dtype: str = "fp32") -> manifest.Cell:
    """The p2_edit cell at the TinyTest ADM's size, 10 steps, 2 sweeps,
    rank 2 + null 3 (unequal, as the configuration's 3 + 5: two iterations,
    not the fused one)."""
    import torch  # noqa: F401

    from loco_edit_tpu_torch.models.adm import ADMUNet
    from loco_edit_tpu_torch.models.adm.presets import tiny_test_config

    cfg = _load("configs/ffhq_p2_f32.json")
    cfg.update(model_name="TinyTest", dtype=dtype)
    cfg["model"] = dict(image_size=32, in_channels=3, model_channels=32, out_channels=6,
                        num_res_blocks=1, attention_ds=[2], channel_mult=[1, 2],
                        num_head_channels=16, num_heads=1, use_scale_shift_norm=True,
                        resblock_updown=True, learn_sigma=True)
    cfg["model"]["parameters"] = sum(p.numel() for p in ADMUNet(tiny_test_config()).parameters())
    cfg["edit"].update(for_steps=10, sweeps=2, pca_rank=2, pca_rank_null=3, vis_num=2,
                       x_space_guidance_num_step=4)
    return manifest.Cell("tiny_p2", "tiny_p2", "fresh_box_edits", 1, cfg,
                         _load("traffic/fresh_box_edits.json"), ["edit_s", "setup_s"],
                         ["forwards", "basis_s"])


def lcm_cell(dtype: str = "fp32") -> manifest.Cell:
    """The lcm_edit cell with the port's tiny SD U-Net preset (no guidance
    embedding; the caller sets LOCO_SD_PRESET=tiny) and the VAE at 64 px, 1 sweep, rank 1 +
    null 1."""
    from loco_edit_tpu_torch.models.sd import SDUNet, sd_preset

    cfg = _load("configs/lcm_dreamshaper_v7_f32.json")
    cfg["dtype"] = dtype
    cfg["unet"] = dict(sample_size=8, in_channels=4, out_channels=4,
                       block_out_channels=[32, 64], layers_per_block=1,
                       cross_attention_dim=32, attention_head_dim=[2, 4],
                       transformer_layers=1, use_linear_projection=True,
                       cross_attn_levels=[True, False], time_cond_proj_dim=None)
    cfg["unet"]["parameters"] = sum(p.numel() for p in SDUNet(sd_preset("tiny")).parameters())
    cfg["edit"].update(sweeps=1, pca_rank=1, pca_rank_null=1)
    return manifest.Cell("tiny_lcm", "tiny_lcm", "fresh_prompt_edits", 1, cfg,
                         _load("traffic/fresh_prompt_edits.json"), ["edit_s", "setup_s"],
                         ["forwards"])

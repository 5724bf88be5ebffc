"""The GroupNorm and attention call shapes of one FFHQ_P2 forward, as the
kernels see them (no JAX here: the card's tests import this module too).

`P2_GN_SHAPES` maps (C, H, W) and `P2_ATTN_SHAPES` maps (heads, N, D) to the
number of calls per forward (65 and 4); `p2_call_shapes` records them from a
forward on the meta device, so a CPU test holds the constants to the model."""

import collections

import torch

P2_GN_SHAPES = {
    (128, 64, 64): 2, (128, 128, 128): 7, (128, 256, 256): 7, (256, 16, 16): 2,
    (256, 32, 32): 7, (256, 64, 64): 6, (256, 128, 128): 2, (256, 256, 256): 2,
    (384, 64, 64): 1, (384, 128, 128): 1, (512, 8, 8): 11, (512, 16, 16): 9,
    (512, 32, 32): 2, (512, 64, 64): 1, (768, 16, 16): 1, (768, 32, 32): 1,
    (1024, 8, 8): 2, (1024, 16, 16): 1,
}
P2_ATTN_SHAPES = {(8, 64, 64): 1, (8, 256, 64): 3}


def p2_call_shapes():
    """(GN counter, attention counter) of one FFHQ_P2 forward on the meta
    device, with the two ops replaced by recorders."""
    from loco_edit_tpu_torch.models.adm import ADMUNet, unet
    from loco_edit_tpu_torch.models.adm.presets import adm_preset

    gn, attn = collections.Counter(), collections.Counter()

    def record_gn(x, scale, bias):
        gn[tuple(x.shape[1:])] += 1
        return x

    def record_attn(q, k, v):
        attn[tuple(q.shape[1:])] += 1
        return q

    saved = unet.group_norm_f32, unet.sdp_attention
    unet.group_norm_f32, unet.sdp_attention = record_gn, record_attn
    try:
        with torch.device("meta"):
            ADMUNet(adm_preset("FFHQ_P2"))(torch.zeros(1, 256, 256, 3), 500.0)
    finally:
        unet.group_norm_f32, unet.sdp_attention = saved
    return gn, attn

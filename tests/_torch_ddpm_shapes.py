"""The GroupNorm and attention call shapes of one CelebA_HQ_HF forward (the
classic 256px DDPM U-Net), as the kernels see them (no JAX here: the card's
tests and chip_smoke.py's checks rely on these constants too).

`DDPM_GN_SHAPES` maps (C, H, W) and `DDPM_ATTN_SHAPES` maps (heads, N, D)
to the number of calls per forward (71 and 6); every GroupNorm runs at eps
1e-6. `ddpm_call_shapes` records them from a forward on the meta device, so
a CPU test holds the constants to the model."""

import collections

import torch

DDPM_PARAMS = 113_673_219
DDPM_GN_EPS = 1e-6
DDPM_GN_SHAPES = {
    (128, 64, 64): 1, (128, 128, 128): 7, (128, 256, 256): 8, (256, 16, 16): 1,
    (256, 32, 32): 7, (256, 64, 64): 6, (256, 128, 128): 2, (256, 256, 256): 3,
    (384, 64, 64): 1, (384, 128, 128): 1, (512, 8, 8): 12, (512, 16, 16): 11,
    (512, 32, 32): 2, (512, 64, 64): 2, (768, 16, 16): 1, (768, 32, 32): 1,
    (1024, 8, 8): 3, (1024, 16, 16): 2,
}
DDPM_ATTN_SHAPES = {(1, 64, 512): 1, (1, 256, 512): 5}


def ddpm_call_shapes():
    """(GN counter, attention counter, set of GN eps) of one CelebA_HQ_HF
    forward on the meta device, with the two ops replaced by recorders."""
    from loco_edit_tpu_torch.models.ddpm import DDPMUNet, ddpm_preset, unet

    gn, attn, eps_seen = collections.Counter(), collections.Counter(), set()

    def record_gn(x, scale, bias, num_groups=32, eps=1e-5):
        gn[tuple(x.shape[1:])] += 1
        eps_seen.add(eps)
        return x

    def record_attn(q, k, v):
        attn[tuple(q.shape[1:])] += 1
        return q

    saved = unet.group_norm_f32, unet.sdp_attention
    unet.group_norm_f32, unet.sdp_attention = record_gn, record_attn
    try:
        with torch.device("meta"):
            DDPMUNet(ddpm_preset("CelebA_HQ_HF"))(torch.zeros(1, 256, 256, 3), 500.0)
    finally:
        unet.group_norm_f32, unet.sdp_attention = saved
    return gn, attn, eps_seen

"""The GroupNorm and attention call shapes of Stable Diffusion 2.1-base, as
the kernels see them (no JAX here: the card's tests and chip_smoke.py's
checks rely on these constants too).

Per U-Net forward (latents 64 x 64, text context 77 x 1024), per VAE decode
(64 x 64 latents -> 512 px) and per VAE encode (512 px -> 64 x 64):
`*_GN_SHAPES` map (C, H, W, eps) and `*_ATTN_SHAPES` map (heads, N_q, N_kv,
D) to the number of calls; `sd_call_shapes` records them from forwards on
the meta device, so a CPU test holds the constants to the models."""

import collections

import torch

SD_UNET_PARAMS = 865_910_724
SD_VAE_DECODER_PARAMS = 49_490_199
SD_VAE_ENCODER_PARAMS = 34_163_664
SD_CONTEXT = (77, 1024)

SD_UNET_GN_SHAPES = {
    (320, 32, 32, 1e-5): 1, (320, 64, 64, 1e-6): 5, (320, 64, 64, 1e-5): 8,
    (640, 16, 16, 1e-5): 1, (640, 32, 32, 1e-6): 5, (640, 32, 32, 1e-5): 6,
    (640, 64, 64, 1e-5): 2, (960, 32, 32, 1e-5): 1, (960, 64, 64, 1e-5): 1,
    (1280, 8, 8, 1e-6): 1, (1280, 8, 8, 1e-5): 11, (1280, 16, 16, 1e-6): 5,
    (1280, 16, 16, 1e-5): 6, (1280, 32, 32, 1e-5): 1, (1920, 16, 16, 1e-5): 1,
    (1920, 32, 32, 1e-5): 1, (2560, 8, 8, 1e-5): 3, (2560, 16, 16, 1e-5): 2,
}
SD_UNET_ATTN_SHAPES = {
    (5, 4096, 4096, 64): 5, (5, 4096, 77, 64): 5,
    (10, 1024, 1024, 64): 5, (10, 1024, 77, 64): 5,
    (20, 256, 256, 64): 5, (20, 256, 77, 64): 5,
    (20, 64, 64, 64): 1, (20, 64, 77, 64): 1,
}
SD_DEC_GN_SHAPES = {
    (128, 512, 512, 1e-6): 6, (256, 256, 256, 1e-6): 5, (256, 512, 512, 1e-6): 1,
    (512, 64, 64, 1e-6): 11, (512, 128, 128, 1e-6): 6, (512, 256, 256, 1e-6): 1,
}
SD_ENC_GN_SHAPES = {
    (128, 256, 256, 1e-6): 1, (128, 512, 512, 1e-6): 4, (256, 128, 128, 1e-6): 1,
    (256, 256, 256, 1e-6): 3, (512, 64, 64, 1e-6): 10, (512, 128, 128, 1e-6): 3,
}
SD_VAE_ATTN_SHAPES = {(1, 4096, 4096, 512): 1}


def sd_call_shapes():
    """{"unet", "decoder", "encoder"} -> (GN counter, attention counter) of
    one forward of each SD 2.1-base model on the meta device, with the two
    ops replaced by recorders; and the three parameter counts."""
    from loco_edit_tpu_torch.models.sd import (SDUNet, VAEConfig, VAEDecoder,
                                               VAEEncoder, sd_preset)
    from loco_edit_tpu_torch.models.sd import unet, vae

    calls = {}
    gn, attn = collections.Counter(), collections.Counter()

    def record_gn(x, scale, bias, num_groups=32, eps=1e-5):
        gn[tuple(x.shape[1:]) + (eps,)] += 1
        return x

    def record_attn(q, k, v):
        attn[(q.shape[1], q.shape[2], k.shape[2], q.shape[3])] += 1
        return q

    saved = unet.group_norm_f32, unet.sdp_attention, vae.sdp_attention
    unet.group_norm_f32, unet.sdp_attention, vae.sdp_attention = (
        record_gn, record_attn, record_attn)
    try:
        with torch.device("meta"):
            models = {"unet": SDUNet(sd_preset("sd21-base")),
                      "decoder": VAEDecoder(VAEConfig()),
                      "encoder": VAEEncoder(VAEConfig())}
            inputs = {"unet": (torch.zeros(1, 64, 64, 4), 500.0,
                               torch.zeros(1, *SD_CONTEXT)),
                      "decoder": (torch.zeros(1, 64, 64, 4),),
                      "encoder": (torch.zeros(1, 512, 512, 3),)}
            for name, m in models.items():
                m(*inputs[name])
                calls[name] = (collections.Counter(gn), collections.Counter(attn))
                gn.clear()
                attn.clear()
    finally:
        unet.group_norm_f32, unet.sdp_attention, vae.sdp_attention = saved
    params = {k: sum(p.numel() for p in m.parameters()) for k, m in models.items()}
    return calls, params

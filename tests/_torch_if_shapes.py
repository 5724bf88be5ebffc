"""The GroupNorm and attention call shapes of DeepFloyd IF-I-M (stage 1,
64 px, the CFG batch of 2) and IF-II-M (stage 2, 256 px), and of the LCM
Dreamshaper v7 U-Net (SD 1.5: 8 heads at every level, head dims 40, 80,
160), as the kernels see them (no JAX here: the card's tests and
chip_smoke.py's checks rely on these constants too).

`*_GN_SHAPES` map (C, H, W, eps) and `*_ATTN_SHAPES` map (heads, N_q, N_kv,
D) to the number of calls per forward; IF's norm_cross is a GroupNorm over
the (77, C) text states, taken as C x 1 x 77; its attention has N_kv = 77 +
N_q (the text keys first). `call_shapes` records them from forwards on the
meta device, so a CPU test holds the constants to the models."""

import collections

import torch

IF_I_M_PARAMS = 426_944_518
IF_II_M_PARAMS = 412_539_270
LCM_UNET_PARAMS = 859_602_884
IF_CONTEXT = (77, 4096)
LCM_CONTEXT = (77, 768)

IF_I_M_GN_SHAPES = {
    (128, 32, 32, 1e-5): 2, (128, 64, 64, 1e-5): 12, (256, 16, 16, 1e-5): 2,
    (256, 32, 32, 1e-5): 18, (256, 64, 64, 1e-5): 4, (384, 32, 32, 1e-5): 1,
    (384, 64, 64, 1e-5): 1, (512, 1, 77, 1e-5): 22, (512, 8, 8, 1e-5): 2,
    (512, 16, 16, 1e-5): 18, (512, 32, 32, 1e-5): 3, (768, 16, 16, 1e-5): 1,
    (768, 32, 32, 1e-5): 1, (1024, 8, 8, 1e-5): 22, (1024, 16, 16, 1e-5): 3,
    (1536, 8, 8, 1e-5): 1, (1536, 16, 16, 1e-5): 1, (2048, 8, 8, 1e-5): 3,
}
IF_I_M_ATTN_SHAPES = {(4, 1024, 1101, 64): 7, (8, 256, 333, 64): 7,
                      (16, 64, 141, 64): 8}
IF_II_M_GN_CALLS, IF_II_M_ATTN_SHAPES = 89, {(16, 1024, 1101, 64): 8}
LCM_ATTN_SHAPES = {
    (8, 4096, 4096, 40): 5, (8, 4096, 77, 40): 5,
    (8, 1024, 1024, 80): 5, (8, 1024, 77, 80): 5,
    (8, 256, 256, 160): 5, (8, 256, 77, 160): 5,
    (8, 64, 64, 160): 1, (8, 64, 77, 160): 1,
}


def call_shapes():
    """{"IF-I-M", "IF-II-M", "LCM"} -> (GN counter, attention counter) of one
    forward of each model on the meta device, with the two ops replaced by
    recorders; and the parameter counts."""
    from loco_edit_tpu_torch.models.ifm import IFUNet, if_preset
    from loco_edit_tpu_torch.models.ifm import unet as if_unet
    from loco_edit_tpu_torch.models.sd import SDUNet, sd_preset
    from loco_edit_tpu_torch.models.sd import unet as sd_unet

    calls = {}
    gn, attn = collections.Counter(), collections.Counter()

    def record_gn(x, scale, bias, num_groups=32, eps=1e-5):
        gn[tuple(x.shape[1:]) + (eps,)] += 1
        return x

    def record_attn(q, k, v):
        attn[(q.shape[1], q.shape[2], k.shape[2], q.shape[3])] += 1
        return q

    # IF's GroupNorms are sd/unet.py's GroupNormF32
    saved = sd_unet.group_norm_f32, sd_unet.sdp_attention, if_unet.sdp_attention
    sd_unet.group_norm_f32 = record_gn
    sd_unet.sdp_attention = if_unet.sdp_attention = record_attn
    try:
        with torch.device("meta"):
            models = {"IF-I-M": IFUNet(if_preset("IF-I-M")),
                      "IF-II-M": IFUNet(if_preset("IF-II-M")),
                      "LCM": SDUNet(sd_preset("lcm-dreamshaper-v7"))}
            inputs = {"IF-I-M": (torch.zeros(2, 64, 64, 3), 500.0,
                                 torch.zeros(2, *IF_CONTEXT)),
                      "IF-II-M": (torch.zeros(2, 256, 256, 6), 500.0,
                                  torch.zeros(2, *IF_CONTEXT), 250.0),
                      "LCM": (torch.zeros(1, 64, 64, 4), 500.0,
                              torch.zeros(1, *LCM_CONTEXT), torch.zeros(1))}
            for name, m in models.items():
                m(*inputs[name])
                calls[name] = (collections.Counter(gn), collections.Counter(attn))
                gn.clear()
                attn.clear()
    finally:
        sd_unet.group_norm_f32, sd_unet.sdp_attention, if_unet.sdp_attention = saved
    params = {k: sum(p.numel() for p in m.parameters()) for k, m in models.items()}
    return calls, params

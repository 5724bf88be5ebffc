"""Helpers shared by the tests that hold loco_edit_tpu_torch against
loco_edit_tpu: NHWC <-> channels_last conversion, the tiny ADM carried from
Flax parameters, and a random stream that yields the JAX package's draws."""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch


def nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (a view)."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


class JaxDraws:
    """Stands in for loco_edit_tpu_torch.core.rng.RngStream and draws what
    loco_edit_tpu.core.rng.RngStream would: fork / at_step fold into a JAX
    key, normal draws jax.random.normal."""

    def __init__(self, key):
        self.key = key

    def fork(self, name: str) -> "JaxDraws":
        from loco_edit_tpu.core.rng import _stable_hash

        return JaxDraws(jax.random.fold_in(self.key, _stable_hash(name)))

    def at_step(self, step: int) -> "JaxDraws":
        return JaxDraws(jax.random.fold_in(self.key, step))

    def normal(self, shape, *, device, dtype=torch.float32) -> torch.Tensor:
        a = np.array(jax.random.normal(self.key, tuple(shape), jnp.float32))
        return torch.from_numpy(a).to(device=device, dtype=dtype)


def tiny_pair(perturb=lambda p: p + 0.02):
    """The tiny ADM in both packages with the same weights: Flax init from
    jax.random.key(0), perturbed, carried by adm_params_from_flax.
    Returns (jax_model, jax_params, torch_model)."""
    from loco_edit_tpu.models.adm import ADMUNet as JaxUNet
    from loco_edit_tpu.models.adm.presets import tiny_test_config as jax_tiny
    from loco_edit_tpu_torch.models.adm import ADMUNet
    from loco_edit_tpu_torch.models.adm.presets import tiny_test_config
    from loco_edit_tpu_torch.models.registry import adm_params_from_flax

    jm = JaxUNet(jax_tiny())
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), 500.0)
    params = jax.tree.map(perturb, params)
    flat = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}
    cfg = tiny_test_config()
    tm = ADMUNet(cfg)
    tm.load_state_dict(adm_params_from_flax(flat, cfg))
    tm.requires_grad_(False).eval()
    return jm, params, tm


def flat_params(params) -> dict:
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}


def _lecun_params(module, seed, *example):
    """Flax parameters of `module` in the shapes jax.eval_shape gives (no
    compiled init): kernels normal with variance 1 / fan_in, norm scales 1,
    biases 0, drawn by numpy from `seed`."""
    rng = np.random.default_rng(seed)
    shapes = flax.traverse_util.flatten_dict(
        jax.eval_shape(module.init, jax.random.key(0), *example))
    out = {}
    for path, sd in sorted(shapes.items()):
        if path[-1] == "kernel":
            a = rng.normal(size=sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))
        else:
            a = np.full(sd.shape, 1.0 if path[-1] == "scale" else 0.0)
        out[path] = jnp.asarray(a, jnp.float32)
    return flax.traverse_util.unflatten_dict(out)


def sd_tiny_pairs():
    """The tiny SD U-Net (sd_preset("tiny")) and a tiny VAE (16 px, channels
    (32, 64), one resnet a level) in both packages with the same weights:
    lecun-normal draws in the Flax shapes (U-Net seed 0, decoder 1, encoder
    2), + 0.01 each (as tiny_pair adds a constant), carried by the port's
    Flax carry. Returns a dict with the JAX modules and params
    ("junet", "pu", "jdec", "pd", "jenc", "pe") and the torch modules
    ("unet", "dec", "enc")."""
    from loco_edit_tpu.models.sd import SDUNet as JUNet
    from loco_edit_tpu.models.sd import VAEConfig as JVAEConfig
    from loco_edit_tpu.models.sd import VAEDecoder as JDec
    from loco_edit_tpu.models.sd import VAEEncoder as JEnc
    from loco_edit_tpu.models.sd import sd_preset as jsd_preset
    from loco_edit_tpu_torch.models.sd import (SDUNet, VAEConfig, VAEDecoder,
                                               VAEEncoder, sd_preset)
    from loco_edit_tpu_torch.models.sd.convert import (sd_params_from_flax,
                                                       vae_params_from_flax)

    vae_kw = dict(sample_size=16, block_out_channels=(32, 64), layers_per_block=1)
    junet, jdec, jenc = JUNet(jsd_preset("tiny")), JDec(JVAEConfig(**vae_kw)), \
        JEnc(JVAEConfig(**vae_kw))
    z = jnp.zeros((1, 8, 8, 4))
    pu = _lecun_params(junet, 0, z, 500.0,
                       jnp.zeros((1, 7, junet.cfg.cross_attention_dim)))
    pd = _lecun_params(jdec, 1, z)
    pe = _lecun_params(jenc, 2, jnp.zeros((1, 16, 16, 3)))
    pu, pd, pe = (jax.tree.map(lambda p: p + 0.01, t) for t in (pu, pd, pe))

    cfg, vcfg = sd_preset("tiny"), VAEConfig(**vae_kw)
    unet, dec, enc = SDUNet(cfg), VAEDecoder(vcfg), VAEEncoder(vcfg)
    unet.load_state_dict(sd_params_from_flax(flat_params(pu), cfg))
    se, sdd = vae_params_from_flax(flat_params(pe), flat_params(pd), vcfg)
    enc.load_state_dict(se)
    dec.load_state_dict(sdd)
    for m in (unet, dec, enc):
        m.requires_grad_(False).eval()
    return dict(junet=junet, pu=pu, jdec=jdec, pd=pd, jenc=jenc, pe=pe,
                unet=unet, dec=dec, enc=enc)


def lcm_tiny_pair():
    """The tiny LCM U-Net (sd_preset("tiny") with time_cond_proj_dim=16, as
    tests/test_pipeline_lcm.py builds it) in both packages with the same
    weights: lecun-normal draws in the Flax shapes (seed 5) + 0.01, carried
    by the SD carry (cond_proj included). Returns (jax_model, jax_params,
    torch_model)."""
    import dataclasses

    from loco_edit_tpu.models.sd import SDUNet as JUNet
    from loco_edit_tpu.models.sd import sd_preset as jsd_preset
    from loco_edit_tpu_torch.models.sd import SDUNet, sd_preset
    from loco_edit_tpu_torch.models.sd.convert import sd_params_from_flax

    jcfg = dataclasses.replace(jsd_preset("tiny"), time_cond_proj_dim=16)
    junet = JUNet(jcfg)
    pu = _lecun_params(junet, 5, jnp.zeros((1, 8, 8, 4)), 500.0,
                       jnp.zeros((1, 7, jcfg.cross_attention_dim)), 6.5)
    pu = jax.tree.map(lambda p: p + 0.01, pu)
    cfg = dataclasses.replace(sd_preset("tiny"), time_cond_proj_dim=16)
    unet = SDUNet(cfg)
    unet.load_state_dict(sd_params_from_flax(flat_params(pu), cfg))
    return junet, pu, unet.requires_grad_(False).eval()


class _ClassMLPGelu:
    """A JAX IF U-Net whose stage-2 class (aug-level) MLP is activated by
    exact GELU, as diffusers builds it and the port follows; the JAX package
    keeps SiLU there. Its other activations are GELU (act_fn "gelu"), so
    jax.nn.silu is swapped for the call, which a jax.jit traces."""

    def __init__(self, junet):
        self.junet = junet

    def apply(self, *args, **kw):
        silu = jax.nn.silu
        jax.nn.silu = functools.partial(jax.nn.gelu, approximate=False)
        try:
            return self.junet.apply(*args, **kw)
        finally:
            jax.nn.silu = silu


def if_tiny_pair(stage2: bool = False, dtype=None):
    """The tiny IF U-Net (tiny_if_config, stage 1 at 16 px or stage 2 at
    32 px) in both packages with the same weights: lecun-normal draws in
    the Flax shapes (seed 6 or 7), the pool's positional embedding normal,
    + 0.01 each, carried by if_params_from_flax. dtype (torch) builds the
    port's module in that dtype from the same weights. Returns (jax_model,
    jax_params, torch_model); stage 2's jax_model is _ClassMLPGelu's."""
    from loco_edit_tpu.models.ifm import IFUNet as JUNet
    from loco_edit_tpu.models.ifm import tiny_if_config as jtiny
    from loco_edit_tpu_torch.models.ifm import IFUNet, if_params_from_flax, tiny_if_config

    jcfg = jtiny(stage2=stage2)
    junet = JUNet(jcfg)
    s = jcfg.sample_size
    ex = (jnp.zeros((1, s, s, jcfg.in_channels)), 500.0,
          jnp.zeros((1, 7, jcfg.encoder_hid_dim)))
    params = _lecun_params(junet, 7 if stage2 else 6, *ex)
    pe = ("params", "add_embedding", "positional_embedding")
    flat = flax.traverse_util.flatten_dict(params)
    flat[pe] = jnp.asarray(np.random.default_rng(8).normal(size=flat[pe].shape)
                           * jcfg.encoder_hid_dim ** -0.5, jnp.float32)
    params = jax.tree.map(lambda p: p + 0.01, flax.traverse_util.unflatten_dict(flat))
    cfg = tiny_if_config(stage2=stage2, **({} if dtype is None else {"dtype": dtype}))
    unet = IFUNet(cfg)
    unet.load_state_dict(if_params_from_flax(flat_params(params), cfg))
    return (_ClassMLPGelu(junet) if stage2 else junet), params, unet.requires_grad_(False).eval()


def tiny_sam_model(decoder_heads: int = 2, window_size: int = 2):
    """The tiny transformers SamModel of tests/test_sam_decoder_flax.py
    (decoder heads and window as given), every parameter perturbed and the
    shared Fourier matrix redrawn, so that every weight carries signal.
    Returns (SamConfig, SamModel)."""
    from transformers import SamConfig, SamModel

    cfg = SamConfig(
        vision_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            image_size=32, patch_size=8, window_size=window_size,
            global_attn_indexes=[1], mlp_ratio=2.0, output_channels=32,
            num_pos_feats=16),
        prompt_encoder_config=dict(
            hidden_size=32, image_size=32, patch_size=8,
            image_embedding_size=4, mask_input_channels=8),
        mask_decoder_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=decoder_heads,
            mlp_dim=64, iou_head_depth=3, iou_head_hidden_dim=16),
        attn_implementation="eager")
    torch.manual_seed(0)
    model = SamModel(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
        model.shared_image_embedding.positional_embedding.copy_(torch.randn(2, 16) * 2.0)
        model._tie_weights()
    return cfg, model

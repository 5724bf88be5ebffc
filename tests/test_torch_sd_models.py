"""The port's Stable Diffusion models against the JAX package on the CPU:
the tiny SD U-Net and a tiny VAE with the same carried Flax weights
(forwards, JVP and VJP, decode(PMP(z)) J.v and v^T J through CFG), the fake
prompt encoder, the diffusers converters, cfg_eps in every mode, and the
SD 2.1-base call shapes and parameter counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.editing import cfg as jax_cfg
from loco_edit_tpu.models.sd import VAEConfig as JVAEConfig
from loco_edit_tpu.models.sd import convert as jax_convert
from loco_edit_tpu.models.sd import sd_preset as jsd_preset
from loco_edit_tpu.models.sd.text import fake_prompt_encoder as jax_fake
from loco_edit_tpu_torch.editing import cfg as torch_cfg
from loco_edit_tpu_torch.models.convert_util import flax_to_state_dict
from loco_edit_tpu_torch.models.sd import (SDUNet, VAEConfig, VAEDecoder, VAEEncoder,
                                           sd_preset)
from loco_edit_tpu_torch.models.sd import convert
from loco_edit_tpu_torch.models.sd.text import fake_prompt_encoder
from _torch_port_utils import flat_params, sd_tiny_pairs
from _torch_sd_shapes import (SD_DEC_GN_SHAPES, SD_ENC_GN_SHAPES, SD_UNET_ATTN_SHAPES,
                              SD_UNET_GN_SHAPES, SD_UNET_PARAMS, SD_VAE_ATTN_SHAPES,
                              SD_VAE_DECODER_PARAMS, SD_VAE_ENCODER_PARAMS,
                              sd_call_shapes)

torch.set_num_threads(2)

# f32 agreement of two frameworks' summation orders through the tiny
# networks, relative to the largest |reference| (measured ~1.2e-6 forward)
RTOL = 1e-5
VAE_KW = dict(sample_size=16, block_out_channels=(32, 64), layers_per_block=1)


@pytest.fixture(scope="module")
def pairs():
    return sd_tiny_pairs()


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=rtol * np.abs(ref).max())


def _inputs(seq, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(batch, 8, 8, 4)).astype(np.float32)
    ctx = (rng.normal(size=(batch, seq, 32)) * 0.2).astype(np.float32)
    return z, ctx


def _jax_jv_vj(f, x, tan, cot):
    """J.tan and cot^T J of f at x, one jitted JAX program."""
    @jax.jit
    def run(x, tan, cot):
        jv = jax.jvp(f, (x,), (tan,))[1]
        return jv, jax.vjp(f, x)[1](cot)[0]

    return run(*map(jnp.asarray, (x, tan, cot)))


@pytest.mark.parametrize("seq", [7, 77])
def test_unet_forward_matches_jax(pairs, seq):
    """f32 eps of the tiny U-Net at context lengths 7 and 77 (the SD text
    length: cross-attention with N_kv = 77)."""
    z, ctx = _inputs(seq)
    ref = jax.jit(pairs["junet"].apply)(pairs["pu"], jnp.asarray(z), 321.0,
                                        jnp.asarray(ctx))
    got = pairs["unet"](torch.from_numpy(z), 321.0, torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_unet_jvp_vjp_match_jax(pairs):
    """jax.jvp / jax.vjp against torch.func.jvp / vjp of the tiny U-Net in
    z, context fixed (tolerance 2e-5 of the largest |value|)."""
    z, ctx = _inputs(77, batch=1, seed=1)
    tan = np.random.default_rng(2).normal(size=z.shape).astype(np.float32)
    cot = np.random.default_rng(3).normal(size=z.shape).astype(np.float32)
    jf = lambda zz: pairs["junet"].apply(pairs["pu"], zz, 500.0, jnp.asarray(ctx))  # noqa: E731
    jv, vj = _jax_jv_vj(jf, z, tan, cot)
    tf = lambda zz: pairs["unet"](zz, 500.0, torch.from_numpy(ctx))  # noqa: E731
    _, tjv = torch.func.jvp(tf, (torch.from_numpy(z),), (torch.from_numpy(tan),))
    _, tpull = torch.func.vjp(tf, torch.from_numpy(z))
    _close(tjv.numpy(), jv, 2e-5)
    _close(tpull(torch.from_numpy(cot))[0].numpy(), vj, 2e-5)


def test_vae_encoder_decoder_match_jax(pairs):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    mean, logvar = jax.jit(pairs["jenc"].apply)(pairs["pe"], jnp.asarray(x))
    tmean, tlogvar = pairs["enc"](torch.from_numpy(x))
    _close(tmean.numpy(), mean)
    _close(tlogvar.numpy(), logvar)
    _close(pairs["dec"](torch.from_numpy(z)).numpy(),
           jax.jit(pairs["jdec"].apply)(pairs["pd"], jnp.asarray(z)))


def test_decode_pmp_jv_and_vjp_match_jax(pairs):
    """J.v and v^T J of decode(PMP(z)) with CFG (null+(for-null), g 5) at
    t = 700: the map the SD basis differentiates (tolerance 2e-5)."""
    z, _ = _inputs(7, batch=1, seed=5)
    prompts_np = {n: (np.random.default_rng(10 + i).normal(size=(1, 7, 32)) * 0.2
                      ).astype(np.float32) for i, n in enumerate(("for", "edit", "null"))}
    tan = np.random.default_rng(6).normal(size=z.shape).astype(np.float32)
    cot = np.random.default_rng(7).normal(size=(1, 16, 16, 3)).astype(np.float32)
    ab, sf = 0.3, 0.18215

    def jf(zz):
        p = {k: jnp.asarray(v) for k, v in prompts_np.items()}
        e = jax_cfg.cfg_eps(lambda a, t, c: pairs["junet"].apply(pairs["pu"], a, t, c),
                            zz, 700.0, p, "null+(for-null)", 5.0)
        return pairs["jdec"].apply(pairs["pd"], (zz - e * np.sqrt(1 - ab)) / np.sqrt(ab) / sf)

    def tf(zz):
        p = {k: torch.from_numpy(v) for k, v in prompts_np.items()}
        e = torch_cfg.cfg_eps(pairs["unet"], zz, 700.0, p, "null+(for-null)", 5.0)
        return pairs["dec"]((zz - e * np.sqrt(1 - ab)) / np.sqrt(ab) / sf)

    jv, vj = _jax_jv_vj(jf, z, tan, cot)
    _, tjv = torch.func.jvp(tf, (torch.from_numpy(z),), (torch.from_numpy(tan),))
    _, tpull = torch.func.vjp(tf, torch.from_numpy(z))
    _close(tjv.numpy(), jv, 2e-5)
    _close(tpull(torch.from_numpy(cot))[0].numpy(), vj, 2e-5)


# the bf16 tiny networks against the f32 JAX ones, relative to the largest
# |reference| (measured ~1e-2 for the U-Net; bf16 keeps 8 significant bits)
BF16_RTOL = 3e-2


def _dtype_trace(jmod, params, tmod, args):
    """Run the JAX module with every submodule's output captured and the
    port's with a forward hook on every submodule: {path: (dtypes of the
    output's leaves)} of each, paths joined with dots, and both outputs."""
    jout, inter = jmod.apply(params, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                       for a in args),
                             capture_intermediates=True, mutable=["intermediates"])
    jtrace = {}

    def walk(tree, path):
        for key, val in tree.items():
            if key == "__call__":
                jtrace[path] = tuple(str(x.dtype) for x in jax.tree.leaves(val[0]))
            else:
                walk(val, f"{path}.{key}" if path else key)

    walk(inter["intermediates"], "")

    def leaves(o):
        return ([o] if isinstance(o, torch.Tensor)
                else [x for item in o for x in leaves(item)])

    ttrace, hooks = {}, []
    for name, m in tmod.named_modules():
        hooks.append(m.register_forward_hook(lambda mod, a, out, name=name: ttrace.__setitem__(
            name, tuple(str(x.dtype).removeprefix("torch.") for x in leaves(out)))))
    with torch.no_grad():
        tout = tmod(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    for h in hooks:
        h.remove()
    return jtrace, ttrace, jout, tout


@pytest.mark.parametrize("which", ["unet", "decoder", "encoder"])
def test_bf16_dtype_flow_matches_jax(pairs, which):
    """The bf16 networks cast where the JAX ones do: every submodule's
    output (the f32 LayerNorm and GroupNorm, the bf16 Linear and conv
    layers, the cast time embedding, the f32 conv_out) has the JAX module's
    dtype, submodule by submodule and name by name; the outputs lie within
    BF16_RTOL of the f32 JAX network's. A cast flipped at any one point
    changes a dtype here, where its rounding alone would hide in bf16."""
    from loco_edit_tpu.models.sd import SDUNet as JUNet
    from loco_edit_tpu.models.sd import VAEDecoder as JDec
    from loco_edit_tpu.models.sd import VAEEncoder as JEnc

    rng = np.random.default_rng(5)
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    if which == "unet":
        ctx = (rng.normal(size=(2, 7, 32)) * 0.5).astype(np.float32)
        jmod, tmod = JUNet(jsd_preset("tiny", dtype=jnp.bfloat16)), SDUNet(
            sd_preset("tiny", dtype=torch.bfloat16))
        args, params, ref = (z, 500.0, ctx), pairs["pu"], pairs["unet"]
        jref = pairs["junet"]
    else:
        jcls, tcls, tag = ((JDec, VAEDecoder, "d") if which == "decoder"
                           else (JEnc, VAEEncoder, "e"))
        jmod = jcls(JVAEConfig(**VAE_KW, dtype=jnp.bfloat16))
        tmod = tcls(VAEConfig(**VAE_KW, dtype=torch.bfloat16))
        args = ((z,) if which == "decoder"
                else (rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32),))
        params, ref = pairs["p" + tag], pairs["dec" if tag == "d" else "enc"]
        jref = pairs["j" + ("dec" if tag == "d" else "enc")]
    tmod.load_state_dict(ref.state_dict())
    tmod.eval()
    jtrace, ttrace, jout, tout = _dtype_trace(jmod, params, tmod, args)
    assert set(ttrace) == set(jtrace)
    assert ttrace == jtrace
    assert {"bfloat16", "float32"} <= {d for ds in jtrace.values() for d in ds}
    want = jref.apply(params, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                for a in args))
    got = tout if isinstance(tout, tuple) else (tout,)
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.float().numpy(), np.asarray(w), BF16_RTOL)


@pytest.mark.parametrize("prompt", ["", "a cat", "a cat with sunglasses"])
def test_fake_prompt_encoder_bit_equal(prompt):
    got = fake_prompt_encoder(32, seq=7, device="cpu")(prompt)
    ref = np.asarray(jax_fake(32, seq=7)(prompt))
    assert got.shape == (1, 7, 32) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


# -- converters: one synthetic diffusers state_dict through both packages ------

def _synthetic_diffusers(model, rules, seed, as_conv=()):
    """A seeded diffusers-named state_dict with the model's shapes; keys whose
    diffusers name ends in one of `as_conv` get 1x1-conv weights (O, I, 1, 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, ref in model.state_dict().items():
        name = convert._rename(key, rules)
        shape = tuple(ref.shape)
        if name.endswith(".weight") and name.rsplit(".", 2)[-2] in as_conv:
            shape += (1, 1)
        out[name] = rng.normal(size=shape).astype(np.float32)
    return out


def _same(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("linear", [True, False])
def test_unet_converter_matches_jax(linear):
    """The tiny U-Net with linear (SD 2.x) or 1x1-conv (SD 1.x) projections:
    both converters give the same parameters bit for bit, and the port's
    rejects a state_dict with an extra key."""
    cfg = sd_preset("tiny")
    cfg = type(cfg)(**{**cfg.__dict__, "use_linear_projection": linear})
    with torch.device("meta"):
        model = SDUNet(cfg)
    sd = _synthetic_diffusers(model, convert._unet_rules(cfg), seed=int(linear))
    jcfg = jsd_preset("tiny")
    jcfg = type(jcfg)(**{**jcfg.__dict__, "use_linear_projection": linear})
    ref = flax_to_state_dict(flat_params(jax_convert.convert_sd_unet_state_dict(sd, jcfg)))
    _same(convert.convert_sd_unet_state_dict(sd, cfg), ref)
    with pytest.raises(ValueError, match="unconsumed"):
        convert.convert_sd_unet_state_dict({**sd, "extra.weight": sd["conv_in.weight"]}, cfg)


@pytest.mark.parametrize("old_attn", [False, True])
def test_vae_converter_matches_jax(old_attn):
    """The tiny VAE in the new (to_q/to_out.0) and old (query/proj_attn,
    1x1-conv weights) attention naming: both converters give the same
    encoder and decoder parameters bit for bit."""
    cfg = VAEConfig(**VAE_KW)
    with torch.device("meta"):
        enc, dec = VAEEncoder(cfg), VAEDecoder(cfg)
    conv = ("query", "key", "value", "proj_attn") if old_attn else ()
    sd = {**_synthetic_diffusers(enc, convert._vae_rules(cfg, "encoder", old_attn), 2, conv),
          **_synthetic_diffusers(dec, convert._vae_rules(cfg, "decoder", old_attn), 3, conv)}
    je, jd = jax_convert.convert_vae_state_dict(sd, JVAEConfig(**VAE_KW))
    pe, pd = convert.convert_vae_state_dict(sd, cfg)
    _same(pe, flax_to_state_dict(flat_params(je)))
    _same(pd, flax_to_state_dict(flat_params(jd)))


# -- classifier-free guidance ---------------------------------------------------

@pytest.mark.parametrize("mode", torch_cfg.CFG_MODES)
def test_cfg_eps_matches_jax(mode):
    """Every CFG mode over a linear stand-in denoiser whose output depends on
    x, t and the context (f32, atol 1e-5 on O(10) values)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    prompts = {n: rng.normal(size=(1, 3, 6)).astype(np.float32)
               for n in ("for", "edit", "null")}

    def make(lib):
        def eps(xx, t, c):
            return xx * (1 + t / 1000) + (c.mean(1) @ lib.asarray(w))[:, None, None, :]
        return eps

    ref = jax_cfg.cfg_eps(make(jnp), jnp.asarray(x), 250.0,
                          {k: jnp.asarray(v) for k, v in prompts.items()}, mode, 7.5, 4.0)
    got = torch_cfg.cfg_eps(make(torch), torch.from_numpy(x), 250.0,
                            {k: torch.from_numpy(v) for k, v in prompts.items()},
                            mode, 7.5, 4.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    off = torch_cfg.cfg_eps(make(torch), torch.from_numpy(x), 250.0,
                            {k: torch.from_numpy(v) for k, v in prompts.items()},
                            mode, 7.5, enabled=False)
    np.testing.assert_allclose(off.numpy(), np.asarray(jax_cfg.cfg_eps(
        make(jnp), jnp.asarray(x), 250.0, {k: jnp.asarray(v) for k, v in prompts.items()},
        mode, 7.5, enabled=False)), atol=1e-5)
    assert torch_cfg.CFG_MODES == jax_cfg.CFG_MODES


def test_perpendicular_component_matches_jax():
    rng = np.random.default_rng(9)
    a, b = (rng.normal(size=(3, 4, 4, 2)).astype(np.float32) for _ in range(2))
    got = torch_cfg.perpendicular_component(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_cfg.perpendicular_component(
        jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    assert np.abs((got.numpy() * b).sum(axis=(1, 2, 3))).max() < 1e-4


# -- SD 2.1-base structure --------------------------------------------------------

def test_sd_call_shapes_and_params_match_the_models():
    """The call shapes the card's tests and chip_smoke.py rely on are the
    ones SD 2.1-base forwards make (61 GN + 32 attention per U-Net forward,
    half of them cross-attention at N_kv = 77; 30 + 1 per decode, 22 + 1 per
    encode), and the parameter counts are those of jax.eval_shape on the
    JAX presets."""
    calls, params = sd_call_shapes()
    assert dict(calls["unet"][0]) == SD_UNET_GN_SHAPES and sum(SD_UNET_GN_SHAPES.values()) == 61
    assert dict(calls["unet"][1]) == SD_UNET_ATTN_SHAPES
    assert sum(v for k, v in SD_UNET_ATTN_SHAPES.items() if k[2] == 77) == 16
    assert sum(SD_UNET_ATTN_SHAPES.values()) == 32
    assert dict(calls["decoder"][0]) == SD_DEC_GN_SHAPES and sum(SD_DEC_GN_SHAPES.values()) == 30
    assert dict(calls["encoder"][0]) == SD_ENC_GN_SHAPES and sum(SD_ENC_GN_SHAPES.values()) == 22
    assert dict(calls["decoder"][1]) == dict(calls["encoder"][1]) == SD_VAE_ATTN_SHAPES
    assert params == {"unet": SD_UNET_PARAMS, "decoder": SD_VAE_DECODER_PARAMS,
                      "encoder": SD_VAE_ENCODER_PARAMS}
    from loco_edit_tpu.models.sd import SDUNet as JUNet
    from loco_edit_tpu.models.sd import VAEDecoder as JDec
    shapes = jax.eval_shape(JUNet(jsd_preset("sd21-base")).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 4)), 500.0, jnp.zeros((1, 77, 1024)))
    assert sum(np.prod(s.shape) for s in jax.tree.leaves(shapes)) == SD_UNET_PARAMS
    shapes = jax.eval_shape(JDec(JVAEConfig()).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 4)))
    assert sum(np.prod(s.shape) for s in jax.tree.leaves(shapes)) == SD_VAE_DECODER_PARAMS


def test_remat_is_refused():
    import dataclasses

    with pytest.raises(NotImplementedError, match="remat"):
        SDUNet(dataclasses.replace(sd_preset("tiny"), remat=True))
    with pytest.raises(NotImplementedError, match="remat"):
        VAEDecoder(VAEConfig(**VAE_KW, remat=True))

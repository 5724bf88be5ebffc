"""The port's DeepFloyd-IF U-Net against the JAX package on the CPU: the tiny
stage-1 and stage-2 U-Nets on the same carried Flax weights (f32 eps, the
aug-level class embedding), the diffusers converter and infer_if_config on
synthetic diffusers-named state_dicts, the bf16 dtype flow of every
submodule, the IF-I-M / IF-II-M / LCM call shapes and parameter counts, and
the T5 encoder's refusal without transformers."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.models.ifm import IFUNet as JUNet
from loco_edit_tpu.models.ifm import convert_if_state_dict as jax_convert
from loco_edit_tpu.models.ifm import if_preset as jif_preset
from loco_edit_tpu.models.ifm import infer_if_config as jax_infer
from loco_edit_tpu.models.ifm import tiny_if_config as jtiny
from loco_edit_tpu_torch.models.ifm import (IFUNet, convert_if_state_dict,
                                            if_params_from_flax, infer_if_config,
                                            tiny_if_config)
from loco_edit_tpu_torch.models.sd.text import t5_prompt_encoder
from _torch_if_shapes import (IF_I_M_ATTN_SHAPES, IF_I_M_GN_SHAPES, IF_I_M_PARAMS,
                              IF_II_M_ATTN_SHAPES, IF_II_M_GN_CALLS, IF_II_M_PARAMS,
                              LCM_ATTN_SHAPES, LCM_UNET_PARAMS, call_shapes)
from _torch_port_utils import flat_params, if_tiny_pair
from _torch_sd_shapes import SD_UNET_GN_SHAPES
from test_if_convert import synthetic_if_state_dict
from test_torch_sd_models import BF16_RTOL, _dtype_trace

torch.set_num_threads(2)

# f32 agreement of two frameworks' summation orders through the tiny
# network, relative to the largest |reference| (measured ~1.6e-6)
RTOL = 1e-5


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def pairs():
    return {st: if_tiny_pair(st) for st in (False, True)}


@pytest.fixture(scope="module")
def applies(pairs):
    """One jitted JAX forward per stage, shared by the tests."""
    return {st: jax.jit(pairs[st][0].apply) for st in (False, True)}


def _jit_dtype_trace(jmod, params, tmod, args):
    """_dtype_trace (tests/test_torch_sd_models.py) with the JAX side's
    capture of every submodule's output compiled once instead of run op by
    op."""
    run = jax.jit(lambda p, *a: jmod.apply(p, *a, capture_intermediates=True,
                                           mutable=["intermediates"]))
    jitted = type("Jitted", (), {"apply": staticmethod(
        lambda p, *a, **_: run(p, *a))})()
    return _dtype_trace(jitted, params, tmod, args)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.sample_size
    x = rng.normal(size=(2, s, s, cfg.in_channels)).astype(np.float32)
    ctx = (rng.normal(size=(2, 7, cfg.encoder_hid_dim)) * 0.5).astype(np.float32)
    return x, ctx


@pytest.mark.parametrize("stage2,aug", [(False, None), (True, 250.0)])
def test_if_unet_forward_matches_jax(pairs, applies, stage2, aug):
    """f32 [eps | sigma] of the tiny IF U-Net: added-KV attention (N_kv = 7
    + H W), norm_cross, the addition embedding, scale-shift res blocks with
    in-block up/downsampling; stage 2 with the aug-level class embedding at
    250."""
    junet, params, unet = pairs[stage2]
    x, ctx = _inputs(unet.cfg)
    extra = () if aug is None else (aug,)
    ref = applies[stage2](params, jnp.asarray(x), 321.0, jnp.asarray(ctx), *extra)
    got = unet(torch.from_numpy(x), 321.0, torch.from_numpy(ctx), *extra)
    assert got.dtype == torch.float32 and got.shape == (2, *x.shape[1:3], 6)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("stage2", [False, True])
def test_infer_and_convert_match_jax(stage2):
    """A synthetic diffusers-named IF state_dict (tests/test_if_convert.py's)
    through both packages: the same inferred geometry, the port's converter
    giving exactly the JAX converter's weights carried by
    if_params_from_flax; a key left unconsumed is an error."""
    sd = synthetic_if_state_dict(stage2=stage2, seed=3)
    cfg, jcfg = infer_if_config(sd), jax_infer(sd)
    for f in ("sample_size", "in_channels", "out_channels", "block_out_channels",
              "layers_per_block", "encoder_hid_dim", "cross_attention_dim",
              "attention_head_dim", "attn_levels", "act_fn", "cross_attention_norm",
              "use_addition_text_embed", "addition_embed_num_heads",
              "class_embed_timestep"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    got = convert_if_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    ref = if_params_from_flax(flat_params(jax_convert(sd, jcfg)), cfg)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    with pytest.raises(ValueError, match="unconsumed"):
        convert_if_state_dict({**sd, "extra.weight": np.zeros(3, np.float32)}, cfg)


def test_converted_checkpoint_forward_matches_jax():
    """The stage-1 synthetic checkpoint loaded through the port's converter
    gives JAX's eps (the weights agree bit for bit, so this holds the
    inferred geometry to the JAX network's)."""
    sd = synthetic_if_state_dict(seed=4)
    cfg, jcfg = infer_if_config(sd, sample_size=8), jax_infer(sd, sample_size=8)
    unet = IFUNet(cfg)
    unet.load_state_dict(convert_if_state_dict(sd, cfg))
    x, ctx = _inputs(cfg, seed=2)
    ref = jax.jit(JUNet(jcfg).apply)(jax.tree.map(jnp.asarray, jax_convert(sd, jcfg)),
                                     jnp.asarray(x), 600.0, jnp.asarray(ctx))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), 600.0, torch.from_numpy(ctx))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("stage2", [False, True])
def test_if_bf16_dtype_flow_matches_jax(pairs, applies, stage2):
    """The bf16 IF U-Net casts where the JAX one does: every submodule's
    output (the f32 time MLPs, addition embedding and LayerNorms, the bf16
    GroupNorms, Linear and conv layers, the f32 conv_out) has the JAX
    module's dtype, name by name; the output lies within BF16_RTOL of the
    f32 JAX network's."""
    junet, params, ref_unet = pairs[stage2]
    jmod = JUNet(jtiny(stage2=stage2, dtype=jnp.bfloat16))
    tmod = IFUNet(tiny_if_config(stage2=stage2, dtype=torch.bfloat16))
    tmod.load_state_dict(ref_unet.state_dict())
    tmod.eval()
    x, ctx = _inputs(tmod.cfg, seed=5)
    args = (x, 500.0, ctx) + ((250.0,) if stage2 else ())
    jtrace, ttrace, _, tout = _jit_dtype_trace(jmod, params, tmod, args)
    assert set(ttrace) == set(jtrace)
    assert ttrace == jtrace
    assert {"bfloat16", "float32"} <= {d for ds in jtrace.values() for d in ds}
    want = applies[stage2](params, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                     for a in args))
    _close(tout.float().numpy(), np.asarray(want), BF16_RTOL)


def test_if_and_lcm_call_shapes_and_params_match_the_models():
    """The call shapes the card's tests and chip_smoke.py rely on are those
    IF-I-M (117 GN + 22 attention per forward, 22 of the GN the norm_cross
    over the 77 text states, N_kv = 77 + N_q), IF-II-M (89 + 8) and the LCM
    U-Net (61 + 32, 8 heads of 40, 80, 160) forwards make; the parameter
    counts of IF-I-M and IF-II-M are those of jax.eval_shape on the JAX
    presets."""
    calls, params = call_shapes()
    gn, attn = calls["IF-I-M"]
    assert dict(gn) == IF_I_M_GN_SHAPES and sum(gn.values()) == 117
    assert dict(attn) == IF_I_M_ATTN_SHAPES and sum(attn.values()) == 22
    assert gn[(512, 1, 77, 1e-5)] == 22
    assert all(nkv == 77 + nq for _, nq, nkv, _ in attn)
    gn2, attn2 = calls["IF-II-M"]
    assert sum(gn2.values()) == IF_II_M_GN_CALLS and dict(attn2) == IF_II_M_ATTN_SHAPES
    gn3, attn3 = calls["LCM"]
    assert dict(gn3) == SD_UNET_GN_SHAPES and dict(attn3) == LCM_ATTN_SHAPES
    assert params == {"IF-I-M": IF_I_M_PARAMS, "IF-II-M": IF_II_M_PARAMS,
                      "LCM": LCM_UNET_PARAMS}
    # the LCM U-Net: SD 1.5's 859,520,964 and the guidance embedding's 256 x 320
    assert LCM_UNET_PARAMS == 859_520_964 + 256 * 320

    def count(module, *example):
        shapes = jax.eval_shape(module.init, jax.random.key(0), *example)
        return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))

    ctx = jnp.zeros((1, 77, 4096))
    assert count(JUNet(jif_preset("IF-I-M")), jnp.zeros((1, 64, 64, 3)), 500.0,
                 ctx) == IF_I_M_PARAMS
    assert count(JUNet(jif_preset("IF-II-M")), jnp.zeros((1, 256, 256, 6)), 500.0,
                 ctx, 250.0) == IF_II_M_PARAMS


def test_t5_prompt_encoder_without_transformers_raises(monkeypatch):
    """Without the transformers package the T5 encoder raises ImportError
    naming the flag, as the CLIP encoder does."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="--text_encoder_path"):
        t5_prompt_encoder("/nonexistent", device="cpu")

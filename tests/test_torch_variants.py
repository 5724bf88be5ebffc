"""The port's ADM variants against the JAX package, through the new Flax
converters: SuperResADMUNet with its conditioning resized up (16 -> 32 px)
and down (48 -> 32 px, jax.image.resize antialiases), EncoderADMUNet with
each of the three pools, and classifier_grad_fn through the encoder.

Weights: lecun-normal numpy draws in the Flax shapes + 0.02 (no compiled
init, _torch_port_utils._lecun_params). Tolerance: 1e-4 of the largest
value (f32 forwards and one gradient, two frameworks' summation orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.models.adm.presets import tiny_test_config as jax_tiny
from loco_edit_tpu.models.adm import variants as jv
from loco_edit_tpu_torch.models.adm import variants
from loco_edit_tpu_torch.models.adm.presets import tiny_test_config
from loco_edit_tpu_torch.models.registry import (encoder_params_from_flax,
                                                 superres_params_from_flax)
from _torch_port_utils import _lecun_params, flat_params

torch.set_num_threads(2)

RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


def _shift(params):
    return jax.tree.map(lambda p: p + 0.02, params)


@pytest.fixture(scope="module")
def superres():
    jcfg = dataclasses.replace(jax_tiny(), in_channels=6)
    jm = jv.SuperResADMUNet(jcfg)
    params = _shift(_lecun_params(jm, 0, jnp.zeros((1, 32, 32, 3)), 500.0,
                                  jnp.zeros((1, 16, 16, 3))))
    cfg = dataclasses.replace(tiny_test_config(), in_channels=6)
    tm = variants.SuperResADMUNet(cfg)
    sd = superres_params_from_flax(flat_params(params), cfg)
    assert all(k.startswith("unet.") for k in sd)
    tm.load_state_dict(sd)
    return jax.jit(lambda x, t, low: jm.apply(params, x, t, low)), tm.eval()


@pytest.mark.parametrize("low_px", [16, 48])
def test_superres_matches_jax(superres, low_px):
    jf, tm = superres
    rng = np.random.default_rng(low_px)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    low = rng.normal(size=(2, low_px, low_px, 3)).astype(np.float32)
    want = jf(x, 300.0, low)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), 300.0, torch.from_numpy(low))
    _close(got, want)
    with torch.no_grad():
        other = tm(torch.from_numpy(x), 300.0, torch.from_numpy(low * 2))
    assert float((other - got).abs().max()) > 1e-4      # the conditioning matters


def _encoder(pool, out_dim=7):
    jm = jv.EncoderADMUNet(jax_tiny(), jv.EncoderHeadConfig(pool=pool, out_dim=out_dim))
    params = _shift(_lecun_params(jm, 1, jnp.zeros((1, 32, 32, 3)), 300.0))
    cfg = tiny_test_config()
    head = variants.EncoderHeadConfig(pool=pool, out_dim=out_dim)
    tm = variants.EncoderADMUNet(cfg, head)
    tm.load_state_dict(encoder_params_from_flax(flat_params(params), cfg, head))
    return jm, params, tm.eval()


@pytest.mark.parametrize("pool", ["adaptive", "spatial", "attention"])
def test_encoder_pools_and_classifier_grad(pool):
    jm, params, tm = _encoder(pool)
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 32, 32, 3)) * 0.5).astype(np.float32)
    japply = jax.jit(lambda z, t: jm.apply(params, z, t))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), 300.0)
    assert tuple(got.shape) == (2, 7) and got.dtype == torch.float32
    _close(got, japply(x, 300.0))
    y = np.array([3, 5])
    want = jax.jit(jv.classifier_grad_fn(japply, jnp.asarray(y)))(jnp.asarray(x), 300.0)
    grad = variants.classifier_grad_fn(lambda z, t: tm(z, t), torch.from_numpy(y))(
        torch.from_numpy(x), 300.0)
    assert float(grad.abs().max()) > 0
    _close(grad, want)


def test_converters_reject_a_mismatched_tree():
    jm, params, _ = _encoder("adaptive")
    flat = flat_params(params)
    cfg = tiny_test_config()
    with pytest.raises(ValueError, match="do not match"):
        encoder_params_from_flax(flat, cfg, variants.EncoderHeadConfig(pool="spatial", out_dim=7))
    with pytest.raises(ValueError, match="do not match"):
        superres_params_from_flax(flat, dataclasses.replace(cfg, in_channels=6))

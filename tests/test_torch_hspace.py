"""The port's h-space toolkit and spectrum utilities against the JAX package,
on the tiny ADM: the bottleneck tap and injection (NHWC, a flat offset
too), the encoder pullback with matched probes, h_to_e, inv_jac, global and
local PCA of the bottleneck with JAX's draws, and the numpy spectrum
functions.

Tolerances: forwards and inv_jac elementwise to 1e-4 of the largest value
(f32, two frameworks' summation orders); h_to_e, a difference of two
forwards, to 1e-4 of the largest eps it is taken from; bases compared by
their principal-angle cosines, at least 0.99997 (the protocol of
tests/test_attention_jvp.py), singular values to rtol 1e-4; the spectrum
functions are the same numpy code and must agree to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.editing import hspace as jhs
from loco_edit_tpu.editing import pullback as jpb
from loco_edit_tpu.utils import spectrum as jsp
from loco_edit_tpu_torch.editing import hspace
from loco_edit_tpu_torch.utils import spectrum
from _torch_port_utils import JaxDraws, tiny_pair

torch.set_num_threads(2)

T = 500.0
RTOL = 1e-4
MIN_COS = 0.99997


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return np.linalg.svd(a @ b.T, compute_uv=False)


@pytest.fixture(scope="module")
def tiny():
    jm, params, tm = tiny_pair()
    jh = jax.jit(lambda z: jm.apply(params, z, T, return_h=True)[-1])
    th = lambda z: tm(z, T, return_h=True)[-1]                          # noqa: E731
    jinj = jax.jit(lambda z, u: jm.apply(params, z, T, h_inject=u))
    tinj = lambda z, u: tm(z, T, h_inject=u)                            # noqa: E731
    x = (np.random.default_rng(0).normal(size=(1, 32, 32, 3)) * 0.5).astype(np.float32)
    return dict(jm=jm, params=params, tm=tm, jh=jh, th=th, jinj=jinj, tinj=tinj, x=x)


def test_tap_layout_and_return_tuple(tiny):
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jout = tiny["jm"].apply(tiny["params"], x, T, return_h=True, return_sigma=True)
    tout = tiny["tm"](torch.from_numpy(x), T, return_h=True, return_sigma=True)
    assert len(tout) == len(jout) == 3          # (eps, logvar, h_mid)
    assert tuple(tout[2].shape) == jout[2].shape == (2, 16, 16, 64)
    for g, w in zip(tout, jout):
        _close(g.detach(), w)
    e_only = tiny["tm"](torch.from_numpy(x), T, return_h=True)
    assert len(e_only) == 2


@pytest.mark.parametrize("flat", [False, True])
def test_h_inject_reads_hwc_order(tiny, flat):
    """A structured offset (not constant over channels or space), NHWC and
    flat: a reshape in the port's NCHW order would scramble it."""
    rng = np.random.default_rng(2)
    u = rng.normal(size=(16, 16, 64)).astype(np.float32) * 0.1
    if flat:
        u = u.reshape(-1)
    x = tiny["x"]
    want = tiny["jinj"](jnp.asarray(x), jnp.asarray(u))
    got = tiny["tinj"](torch.from_numpy(x), torch.from_numpy(u))
    _close(got.detach(), want)
    base = tiny["tm"](torch.from_numpy(x), T)
    assert float((got - base).abs().max()) > 1e-3


def test_local_encoder_pullback_matched_probes(tiny):
    x = tiny["x"]
    v0 = np.array(jpb.init_probes(jax.random.key(3), 3, x.size))
    kw = dict(rank=3, min_iter=3, max_iter=4, tol=0.0)
    bj = jax.jit(lambda z: jhs.local_encoder_pullback(
        tiny["jh"], z, None, pad_probes=False, v_init=jnp.asarray(v0), **kw))(jnp.asarray(x))
    bt = hspace.local_encoder_pullback(tiny["th"], torch.from_numpy(x), None,
                                       v_init=torch.from_numpy(v0), device="cpu", **kw)
    assert bt.iters == int(bj.iters) == 4
    assert tuple(bt.u.shape) == bj.u.shape == (3, 1, 16, 16, 64)
    assert _cosines(bt.vT, bj.vT).min() > MIN_COS
    np.testing.assert_allclose(bt.s.numpy(), np.asarray(bj.s), rtol=RTOL)


def test_h_to_e_and_inv_jac(tiny):
    x = tiny["x"]
    rng = np.random.default_rng(4)
    u = rng.normal(size=(3, 16 * 16 * 64)).astype(np.float32)
    want = jhs.h_to_e(tiny["jinj"], jnp.asarray(x), jnp.asarray(u[0].reshape(16, 16, 64)), 0.5)
    got = hspace.h_to_e(tiny["tinj"], torch.from_numpy(x),
                        torch.from_numpy(u[0].reshape(16, 16, 64)), 0.5, device="cpu")
    scale = float(np.abs(np.asarray(tiny["jinj"](jnp.asarray(x), None))).max())
    assert np.abs(got.numpy() - np.asarray(want)).max() <= RTOL * scale
    assert float(got.abs().max()) > 1e-3
    for perturb in (0.1, -0.3):
        want = jhs.inv_jac(tiny["jh"], jnp.asarray(x), jnp.asarray(u), perturb)
        got = hspace.inv_jac(tiny["th"], torch.from_numpy(x), torch.from_numpy(u), perturb,
                             device="cpu")
        assert tuple(got.shape) == (3, x.size)
        _close(got, want)
    one = hspace.inv_jac(tiny["th"], torch.from_numpy(x), torch.from_numpy(u[1]), device="cpu")
    _close(one, jhs.inv_jac(tiny["jh"], jnp.asarray(x), jnp.asarray(u[1])))


@pytest.mark.parametrize("n,chunk", [(6, 0), (5, 2), (6, 3)])
def test_global_pca_h(tiny, n, chunk):
    """Including a population that does not divide the chunk (5 by 2)."""
    xs = np.random.default_rng(5).normal(size=(n, 32, 32, 3)).astype(np.float32)
    jh1 = lambda z: tiny["jm"].apply(tiny["params"], z, T, return_h=True)[-1]  # noqa: E731
    sj, cj = jax.jit(lambda a: jhs.global_pca_h(jh1, a, rank=3, chunk=chunk))(jnp.asarray(xs))
    st, ct = hspace.global_pca_h(tiny["th"], torch.from_numpy(xs), rank=3, chunk=chunk,
                                 device="cpu")
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=RTOL)
    assert _cosines(ct, cj).min() > MIN_COS
    np.testing.assert_allclose(np.linalg.norm(ct.numpy(), axis=1), 1.0, atol=1e-5)


def test_local_pca_h_with_jax_probes(tiny):
    x = tiny["x"]
    key = jax.random.key(6)
    cj = jax.jit(lambda z: jhs.local_pca_h(tiny["jh"], z, key, rank=3, n_probes=12))(
        jnp.asarray(x))
    ct = hspace.local_pca_h(tiny["th"], torch.from_numpy(x), JaxDraws(key), rank=3,
                            n_probes=12, device="cpu")
    assert tuple(ct.shape) == (3, 16 * 16 * 64)
    assert _cosines(ct, cj).min() > MIN_COS


def test_entry_points_raise_without_a_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = torch.from_numpy(tiny["x"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hspace.global_pca_h(tiny["th"], x, rank=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hspace.inv_jac(tiny["th"], x, torch.ones(16 * 16 * 64))


def test_spectrum_functions_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(spectrum.power_spectral_density(x),
                               jsp.power_spectral_density(x), rtol=1e-6)
    np.testing.assert_allclose(spectrum.low_pass_filter(x, 0.3),
                               jsp.low_pass_filter(x, 0.3), rtol=1e-6, atol=1e-7)
    v = rng.normal(size=(2, 16 * 16 * 3)).astype(np.float32)
    np.testing.assert_allclose(spectrum.fourier_regularize(v, (16, 16, 3)),
                               jsp.fourier_regularize(v, (16, 16, 3)), rtol=1e-6, atol=1e-7)
    spectrum.save_psd_plot([x, x * 0.5], str(tmp_path / "a" / "psd.png"))
    jsp.save_psd_plot([x, x * 0.5], str(tmp_path / "b" / "psd.png"))
    for name in ("psd.png", "psd.png.npz"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()

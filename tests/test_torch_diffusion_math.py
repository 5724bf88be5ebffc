"""The port's diffusion maths against the JAX package: respacing, the KL and
discretized likelihood terms, the posterior and the learned-sigma variance,
the hybrid loss, calc_bpd_loop over a 10-step respaced schedule through the
tiny learned-sigma ADM with matched noise, and ancestral sampling with JAX's
per-step noise injected, with and without classifier guidance.

Tolerances: the closed-form terms agree to f32 rounding (rtol 1e-5); the
network paths (bpd, sampling) to 1e-4 of their largest value, which leaves
room for the two frameworks' summation orders through ten forwards. The one
exception is the t = 0 decoder term of calc_bpd_loop (DECODER_RTOL): its
likelihood is a difference of two normal CDFs near 1, which f32 holds to
about 6e-8, so where the model's mean lies a few scales from x0 (the tiny
random model's does) each framework's tanh rounding moves it by up to ~1e-2
relative; the terms at t >= 1, the prior and the MSE ledgers stay at 1e-4.
test_decoder_term_witness backs this: the term evaluated in float64 from
each package's own t = 0 means and log-scales agrees to 1.4e-7 relative
(DECODER_WITNESS_RTOL 1e-6), so the means agree and the gap is the f32
evaluation of the CDF difference (f32 against float64: ~3e-2 here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.diffusion import ancestral as jan
from loco_edit_tpu.diffusion import losses as jlo
from loco_edit_tpu.diffusion import respace as jre
from loco_edit_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from loco_edit_tpu_torch.diffusion import losses, respace
from loco_edit_tpu_torch.diffusion.ancestral import p_sample_scan
from loco_edit_tpu_torch.diffusion.schedule import NoiseSchedule
from _torch_port_utils import JaxDraws, tiny_pair

torch.set_num_threads(2)

RTOL = 1e-5      # closed-form terms: f32 rounding
NET_RTOL = 1e-4  # through the network, relative to the largest value
DECODER_RTOL = 1e-2
DECODER_WITNESS_RTOL = 1e-6   # the float64 decoder terms of both packages' means
STEPS = 10


def _close(got, want, rtol=NET_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


@pytest.fixture(scope="module")
def model():
    jm, params, tm = tiny_pair()
    sched, tmap = respace.respaced_schedule(NoiseSchedule.linear(), STEPS)
    jsched, jtmap = jre.respaced_schedule(JaxSchedule.linear(), STEPS)
    np.testing.assert_array_equal(tmap, jtmap)
    jt = jnp.asarray(jtmap, jnp.float32)
    tt = torch.from_numpy(tmap).float()

    def j_out(z, t):
        return jm.apply(params, z, jt[t], return_sigma=True)

    def t_out(z, t):
        return tm(z, tt[t], return_sigma=True)

    return dict(jmath=jlo.GaussianDiffusionMath(jsched),
                tmath=losses.GaussianDiffusionMath(sched), j_out=j_out, t_out=t_out)


@pytest.mark.parametrize("spec", ["ddim10", "10,20", 25, "7", [3, 5, 2]])
def test_space_timesteps_and_respaced_schedule_equal(spec):
    assert respace.space_timesteps(1000, spec) == jre.space_timesteps(1000, spec)
    s, tmap = respace.respaced_schedule(NoiseSchedule.linear(), spec)
    js, jtmap = jre.respaced_schedule(JaxSchedule.linear(), spec)
    np.testing.assert_array_equal(tmap, jtmap)
    np.testing.assert_array_equal(s.betas, js.betas)
    np.testing.assert_array_equal(s.alphas_cumprod, js.alphas_cumprod)


def test_kl_and_discretized_likelihood():
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.normal(size=(2, 4, 4, 3)).astype(np.float32) for _ in range(4))
    got = losses.normal_kl(*(torch.from_numpy(v) for v in (a, b, c, d)))
    _close(got, jlo.normal_kl(a, b, c, d), RTOL)
    _close(losses.normal_kl(torch.from_numpy(a), torch.from_numpy(b), 0.0, 0.0),
           jlo.normal_kl(a, b, 0.0, 0.0), RTOL)
    x = np.tanh(rng.normal(size=(2, 4, 4, 3)) * 0.8).astype(np.float32)
    x[0, 0, 0] = 1.0       # the saturated-pixel branches
    x[1, 1, 1] = -1.0
    # means within a few scales of x: far out, plus - minus cancels to a
    # rounding residue of 1 - 1e-7 that each framework's tanh rounds apart
    means, ls = x + 0.1 * a, 0.3 * b - 1.5
    got = losses.discretized_gaussian_log_likelihood(
        torch.from_numpy(x), torch.from_numpy(means), torch.from_numpy(ls))
    _close(got, jlo.discretized_gaussian_log_likelihood(x, means, ls), RTOL)


def test_posterior_learned_sigma_prior_and_hybrid_loss(model):
    jmath, tmath = model["jmath"], model["tmath"]
    rng = np.random.default_rng(1)
    x0 = np.tanh(rng.normal(size=(3, 8, 8, 3))).astype(np.float32)
    xt, eps, frac = (rng.normal(size=(3, 8, 8, 3)).astype(np.float32) for _ in range(3))
    frac = np.tanh(frac)
    t = np.array([0, 4, 9], np.int32)
    T = [torch.from_numpy(v) for v in (x0, xt, eps, frac)]
    tt = torch.from_numpy(t).long()
    for g, j in zip(tmath.q_posterior_mean_logvar(T[0], T[1], tt),
                    jmath.q_posterior_mean_logvar(x0, xt, t)):
        _close(g, j, RTOL)
    for clip in (True, False):
        for g, j in zip(tmath.p_mean_logvar(T[1], tt, T[2], T[3], clip_x0=clip),
                        jmath.p_mean_logvar(xt, t, eps, frac, clip_x0=clip)):
            _close(g, j, RTOL)
    _close(tmath.q_sample(T[0], tt, T[2]), jmath.q_sample(x0, t, eps), RTOL)
    _close(tmath.prior_bpd(T[0]), jmath.prior_bpd(x0), RTOL)
    _close(tmath.vb_term(T[0], T[1], tt, T[2], T[3]), jmath.vb_term(x0, xt, t, eps, frac), RTOL)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    got = losses.hybrid_loss(tmath, T[1], tt, torch.from_numpy(noise), T[2], T[3], T[0], 0.5)
    _close(got, jlo.hybrid_loss(jmath, xt, t, noise, eps, frac, x0, 0.5), RTOL)


def test_vb_term_detaches_the_mean(model):
    """The VLB term trains only the variance: its gradient through eps is 0."""
    tmath = model["tmath"]
    rng = np.random.default_rng(2)
    x0, xt, eps, frac = (torch.from_numpy(rng.normal(size=(2, 4, 4, 3)).astype(np.float32))
                         for _ in range(4))
    eps.requires_grad_(True)
    frac.requires_grad_(True)
    tmath.vb_term(x0.tanh(), xt, torch.tensor([3, 6]), eps, frac.tanh()).sum().backward()
    assert eps.grad is None or float(eps.grad.abs().max()) == 0.0
    assert float(frac.grad.abs().max()) > 0


def test_calc_bpd_loop_matched_noise(model):
    rng = np.random.default_rng(3)
    x0 = np.tanh(rng.normal(size=(2, 32, 32, 3)) * 0.7).astype(np.float32)
    x0[0, 0, :4] = 1.0
    noise = rng.normal(size=(STEPS,) + x0.shape).astype(np.float32)
    want = jax.jit(lambda a, n: model["jmath"].calc_bpd_loop(
        model["j_out"], a, noise=n, learned_sigma=True))(jnp.asarray(x0), jnp.asarray(noise))
    got = model["tmath"].calc_bpd_loop(model["t_out"], torch.from_numpy(x0),
                                       noise=torch.from_numpy(noise), learned_sigma=True)
    assert set(got) == set(want)
    assert got["vb"].shape == (2, STEPS)
    _close_bpd(got, want)
    for k in ("prior_bpd", "xstart_mse", "mse"):
        _close(got[k], want[k])


def _close_bpd(got, want):
    """vb[:, -1] is the t = 0 decoder term (DECODER_RTOL); the KL terms and
    total_bpd without it at NET_RTOL."""
    vb, jvb = got["vb"].numpy(), np.asarray(want["vb"])
    _close(vb[:, :-1], jvb[:, :-1])
    _close(vb[:, -1], jvb[:, -1], DECODER_RTOL)
    _close(got["total_bpd"].numpy() - vb[:, -1],
           np.asarray(want["total_bpd"]) - jvb[:, -1])


def _decoder_term64(x0, mean, log_scale) -> np.ndarray:
    """The t = 0 decoder term (bits, mean over pixels) in float64, with the
    tanh CDF of discretized_gaussian_log_likelihood."""
    def cdf(v):
        return 0.5 * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (v + 0.044715 * v ** 3)))

    x0, mean, log_scale = (np.asarray(a, np.float64) for a in (x0, mean, log_scale))
    centered, inv_std = x0 - mean, np.exp(-log_scale)
    plus, minus = cdf(inv_std * (centered + 1 / 255)), cdf(inv_std * (centered - 1 / 255))
    ll = np.where(x0 < -0.999, np.log(np.maximum(plus, 1e-12)),
                  np.where(x0 > 0.999, np.log(np.maximum(1 - minus, 1e-12)),
                           np.log(np.maximum(plus - minus, 1e-12))))
    return -ll.reshape(ll.shape[0], -1).mean(axis=1) / np.log(2.0)


def test_decoder_term_witness(model):
    """Why the t = 0 decoder term is held at DECODER_RTOL: each package's
    own means and log-scales at t = 0, on the inputs of
    test_calc_bpd_loop_matched_noise, give the same term in float64 to
    DECODER_WITNESS_RTOL. The means agree; the f32 terms differ only by
    the rounding of the CDF difference near 1."""
    rng = np.random.default_rng(3)
    x0 = np.tanh(rng.normal(size=(2, 32, 32, 3)) * 0.7).astype(np.float32)
    x0[0, 0, :4] = 1.0
    nz = rng.normal(size=(STEPS,) + x0.shape).astype(np.float32)[-1]   # t = 0
    jmath, tmath = model["jmath"], model["tmath"]
    t0 = np.zeros((2,), np.int32)
    jxt = jmath.q_sample(jnp.asarray(x0), t0, jnp.asarray(nz))
    jmean, jlogvar, _ = jmath.p_mean_logvar(jxt, t0, *model["j_out"](jxt, t0))
    tt0 = torch.zeros((2,), dtype=torch.long)
    with torch.no_grad():
        txt = tmath.q_sample(torch.from_numpy(x0), tt0, torch.from_numpy(nz))
        tmean, tlogvar, _ = tmath.p_mean_logvar(txt, tt0, *model["t_out"](txt, tt0))
    j64 = _decoder_term64(x0, jmean, 0.5 * np.asarray(jlogvar))
    t64 = _decoder_term64(x0, tmean.numpy(), 0.5 * tlogvar.numpy())
    print("decoder term, float64 from JAX's / the port's means:", j64, t64,
          "relative gap", np.abs(t64 - j64).max() / np.abs(j64).max())
    assert np.abs(t64 - j64).max() / np.abs(j64).max() <= DECODER_WITNESS_RTOL


def test_calc_bpd_loop_draws_per_step_from_rng(model):
    """Without `noise`, the step at t draws rng.at_step(t): JAX's
    fold_in(key, t) draws through JaxDraws give JAX's result."""
    x0 = np.tanh(np.random.default_rng(4).normal(size=(1, 32, 32, 3))).astype(np.float32)
    key = jax.random.key(7)
    want = jax.jit(lambda a: model["jmath"].calc_bpd_loop(
        model["j_out"], a, key, learned_sigma=True))(jnp.asarray(x0))
    got = model["tmath"].calc_bpd_loop(model["t_out"], torch.from_numpy(x0), JaxDraws(key),
                                       learned_sigma=True)
    _close_bpd(got, want)


@pytest.mark.parametrize("guided", [False, True])
def test_p_sample_scan_with_jax_noise(model, guided):
    xT = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(11)
    ts = np.arange(STEPS - 1, -1, -1)[::2]     # a strided subset, as callers pass
    target = np.float32(0.3)

    def j_grad(x, t):
        return -(x - target) * 0.5

    def t_grad(x, t):
        return -(x - target) * 0.5

    want = jax.jit(lambda z: jan.p_sample_scan(
        lambda x, t: model["j_out"](x, t)[0], z, model["jmath"], key, timesteps=ts,
        logvar_frac_fn=lambda x, t: model["j_out"](x, t)[1],
        cond_grad_fn=j_grad if guided else None, guidance_scale=2.0))(jnp.asarray(xT))
    got = p_sample_scan(
        lambda x, t: model["t_out"](x, t)[0], torch.from_numpy(xT), model["tmath"],
        JaxDraws(key), timesteps=ts, logvar_frac_fn=lambda x, t: model["t_out"](x, t)[1],
        cond_grad_fn=t_grad if guided else None, guidance_scale=2.0, device="cpu")
    _close(got, want)


def test_p_sample_scan_raises_without_a_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_sample_scan(lambda x, t: x, torch.zeros(1, 4, 4, 3), model["tmath"], JaxDraws(None))

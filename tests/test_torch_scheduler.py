"""The port's scheduler against the JAX package's: the host grids are
bit-equal, the step math agrees in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.diffusion import scheduler as jsched
from loco_edit_tpu_torch.diffusion import scheduler as tsched

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [10, 100])
@pytest.mark.parametrize("noise_schedule", ["linear", "cosine", "scaled_linear"])
def test_grids_bit_equal(n, noise_schedule):
    j = jsched.LinspaceDDIM(noise_schedule=noise_schedule)
    t = tsched.LinspaceDDIM(noise_schedule=noise_schedule)
    for kind in ("generation_grid", "inversion_grid"):
        gj, gt = getattr(j, kind)(n), getattr(t, kind)(n)
        assert gj.is_inversion == gt.is_inversion and len(gj) == len(gt)
        for field in ("t", "t_next", "alpha_bar", "alpha_bar_next", "beta"):
            a, b = getattr(gj, field), getattr(gt, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), (kind, field)
    for frac in (0.0, 0.2, 0.5, 0.6, 1.0):
        assert j.nearest_step_index(n, frac) == t.nearest_step_index(n, frac)
        assert np.array_equal(j.boost_eta_flags(n, frac), t.boost_eta_flags(n, frac))


def _pair(seed, shape=(2, 8, 8, 3)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_step_and_pmp_match_f32(eta):
    """f32 scalar coefficients formed on the host equal the JAX step's: the
    outputs agree to 2 ulp-scale (atol 1e-6 at |x| ~ 1-10)."""
    x, e = _pair(0)
    noise = _pair(1)[0]
    grid = tsched.LinspaceDDIM().generation_grid(100)
    for i in (0, 37, 98):
        ab, abn = grid.alpha_bar[i], grid.alpha_bar_next[i]
        xj, x0j = jsched.ddim_step(jnp.asarray(x), jnp.asarray(e), ab, abn,
                                   eta=eta, noise=jnp.asarray(noise))
        xt, x0t = tsched.ddim_step(torch.from_numpy(x), torch.from_numpy(e),
                                   ab, abn, eta=eta, noise=torch.from_numpy(noise))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(x0t.numpy(), np.asarray(x0j), rtol=1e-6, atol=1e-6)
        pj = jsched.pmp(jnp.asarray(x), jnp.asarray(e), ab)
        pt = tsched.pmp(torch.from_numpy(x), torch.from_numpy(e), ab)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)


def test_ddpm_learned_sigma_step_matches():
    x, e = _pair(2)
    lv, noise = _pair(3)
    g = tsched.LinspaceDDIM().generation_grid(10)
    yj = jsched.ddpm_step_learned_sigma(jnp.asarray(x), jnp.asarray(e),
                                        jnp.asarray(lv), g.beta[3],
                                        g.alpha_bar[3], jnp.asarray(noise))
    yt = tsched.ddpm_step_learned_sigma(torch.from_numpy(x), torch.from_numpy(e),
                                        torch.from_numpy(lv), g.beta[3],
                                        g.alpha_bar[3], torch.from_numpy(noise))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)


def test_sampling_loops_match_with_injected_noise():
    """ddim_invert / ddim_generate with a toy eps and the JAX fold_in noise
    injected through the stream hook (sampling.py:52-55)."""
    import jax

    from loco_edit_tpu.diffusion import sampling as jsamp
    from loco_edit_tpu_torch.diffusion import sampling as tsamp

    def eps_j(x, t):
        return jnp.tanh(x) * (t / 1000.0)

    def eps_t(x, t):
        return torch.tanh(x) * (t / 1000.0)

    key = jax.random.key(3)

    class JaxDraws:
        def __init__(self, k):
            self.k = k

        def at_step(self, s):
            return JaxDraws(jax.random.fold_in(self.k, s))

        def normal(self, shape, *, device, dtype=torch.float32):
            return torch.from_numpy(np.array(jax.random.normal(self.k, shape)))

    s = tsched.LinspaceDDIM()
    x0 = _pair(4)[0] * 0.5
    inv_j = jsamp.ddim_invert(eps_j, jnp.asarray(x0), s.inversion_grid(10), refine_steps=1)
    inv_t = tsamp.ddim_invert(eps_t, torch.from_numpy(x0), s.inversion_grid(10),
                              refine_steps=1)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), atol=1e-5)
    eta = s.boost_eta_flags(10, 0.5)
    gen_j = jsamp.ddim_generate(eps_j, jnp.asarray(x0), s.generation_grid(10),
                                start_idx=2, eta=eta, rng_key=key)
    gen_t = tsamp.ddim_generate(eps_t, torch.from_numpy(x0), s.generation_grid(10),
                                start_idx=2, eta=eta, rng=JaxDraws(key))
    np.testing.assert_allclose(gen_t.numpy(), np.asarray(gen_j), atol=1e-5)

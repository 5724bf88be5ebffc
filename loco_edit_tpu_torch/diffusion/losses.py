"""Diffusion training losses: KL terms, discretized likelihoods, hybrid VLB
(port of loco_edit_tpu/diffusion/losses.py).

Gaussian KL, the discretized gaussian log-likelihood of x0, the posterior
q(x_{t-1}|x_t,x0), the learned-sigma interpolation and the hybrid MSE+VLB
objective with the mean detached for the VLB term (the reference's
guided_diffusion losses.py:12-77 and gaussian_diffusion.py:171-326,744-817).
The schedule tables stay numpy float64 on the host and are read as float32
at the point of use, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from loco_edit_tpu_torch.diffusion.schedule import NoiseSchedule


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) elementwise in nats; any argument may be a float."""
    ref = next(a for a in (mean1, logvar1, mean2, logvar2)
               if isinstance(a, torch.Tensor))
    logvar1, logvar2 = _like(logvar1, ref), _like(logvar2, ref)
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _approx_std_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """Log-likelihood of images discretized to 255 bins under a gaussian;
    x in [-1, 1]."""
    centered = x - means
    inv_std = torch.exp(-log_scales)
    plus = _approx_std_normal_cdf(inv_std * (centered + 1.0 / 255.0))
    minus = _approx_std_normal_cdf(inv_std * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(plus, min=1e-12))
    log_one_minus_cdf_minus = torch.log(torch.clamp(1.0 - minus, min=1e-12))
    cdf_delta = plus - minus
    return torch.where(
        x < -0.999, log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_minus,
                    torch.log(torch.clamp(cdf_delta, min=1e-12))))


def _mean_rest(a: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the first."""
    return a.mean(dim=tuple(range(1, a.ndim)))


class GaussianDiffusionMath:
    """Closed-form q/p moments over a NoiseSchedule (host tables, torch math
    on the device of the tensors given)."""

    def __init__(self, schedule: NoiseSchedule):
        self.schedule = schedule
        ab = schedule.alphas_cumprod
        ab_prev = np.concatenate([[1.0], ab[:-1]])
        betas = schedule.betas
        self.posterior_variance = betas * (1.0 - ab_prev) / (1.0 - ab)
        self.posterior_log_variance_clipped = np.log(
            np.concatenate([[self.posterior_variance[1]],
                            self.posterior_variance[1:]]))
        self.posterior_mean_coef1 = betas * np.sqrt(ab_prev) / (1.0 - ab)
        self.posterior_mean_coef2 = ((1.0 - ab_prev) * np.sqrt(1.0 - betas)
                                     / (1.0 - ab))
        self._ab = ab
        self._betas = betas
        self._tables: dict = {}

    def _g(self, table, t, like: torch.Tensor) -> torch.Tensor:
        """table[t] as float32, then like.dtype, broadcastable against like."""
        key = (id(table), like.device)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(np.asarray(table, np.float32),
                                                device=like.device)
        v = self._tables[key][torch.as_tensor(t, device=like.device).long()]
        return v.reshape(v.shape + (1,) * (like.ndim - v.ndim)).to(like.dtype)

    def predict_x0_from_eps(self, xt, t, eps):
        ab = self._g(self._ab, t, xt)
        return (xt - torch.sqrt(1.0 - ab) * eps) / torch.sqrt(ab)

    def q_posterior_mean_logvar(self, x0, xt, t):
        mean = (self._g(self.posterior_mean_coef1, t, xt) * x0
                + self._g(self.posterior_mean_coef2, t, xt) * xt)
        logvar = self._g(self.posterior_log_variance_clipped, t, xt)
        return mean, logvar

    def p_mean_logvar(self, xt, t, eps, model_logvar_frac=None,
                      clip_x0: bool = True):
        """Model p(x_{t-1}|x_t): mean from the predicted x0; variance fixed
        small, or the learned interpolation between beta_t and the
        posterior's (gaussian_diffusion.py:253-283)."""
        x0 = self.predict_x0_from_eps(xt, t, eps)
        if clip_x0:
            x0 = torch.clamp(x0, -1.0, 1.0)
        mean, post_logvar = self.q_posterior_mean_logvar(x0, xt, t)
        if model_logvar_frac is None:
            return mean, post_logvar, x0
        max_log = torch.log(self._g(self._betas, t, xt))
        frac = (model_logvar_frac + 1.0) / 2.0
        logvar = frac * max_log + (1.0 - frac) * post_logvar
        return mean, logvar, x0

    def q_mean_logvar(self, x0, t):
        """Moments of q(x_t | x_0)."""
        ab = self._g(self._ab, t, x0)
        return torch.sqrt(ab) * x0, torch.log(1.0 - ab)

    def q_sample(self, x0, t, noise):
        ab = self._g(self._ab, t, x0)
        return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise

    def prior_bpd(self, x0):
        """KL(q(x_T|x_0) || N(0, I)) in bits/dim, per batch element."""
        t = torch.full((x0.shape[0],), self._ab.shape[0] - 1, dtype=torch.long,
                       device=x0.device)
        mean, logvar = self.q_mean_logvar(x0, t)
        return _mean_rest(normal_kl(mean, logvar, 0.0, 0.0)) / np.log(2.0)

    @torch.no_grad()
    def calc_bpd_loop(self, model_fn, x0, rng=None, *, learned_sigma=False,
                      clip_x0=True, noise=None):
        """Full variational-bound evaluation: one VLB term per timestep of
        the schedule, swept T-1..0 with one forward each under no_grad (the
        reference's calc_bpd_loop, gaussian_diffusion.py:838-893; the JAX
        package scans the same body).

        model_fn(xt, t_batch) -> eps, or (eps, logvar_frac) when
        learned_sigma. noise: optional (T, *x0.shape) tensor (index i holds
        the draw for t = T-1-i) for deterministic evaluation; otherwise each
        step draws from `rng.at_step(t)` (a core/rng.py RngStream).

        Returns dict(total_bpd (N,), prior_bpd (N,), vb (N, T),
        xstart_mse (N, T), mse (N, T)); vb[:, j] is the term at t = T-1-j.
        """
        if rng is None and noise is None:
            raise ValueError("provide rng or noise")
        T = self._ab.shape[0]
        n = x0.shape[0]
        vbs, xms, mss = [], [], []
        for i, ti in enumerate(range(T - 1, -1, -1)):
            t = torch.full((n,), ti, dtype=torch.long, device=x0.device)
            nz = (noise[i].to(x0) if noise is not None else
                  rng.at_step(ti).normal(x0.shape, device=x0.device, dtype=x0.dtype))
            xt = self.q_sample(x0, t, nz)
            out = model_fn(xt, t)
            eps, frac = out if learned_sigma else (out, None)
            true_mean, true_logvar = self.q_posterior_mean_logvar(x0, xt, t)
            mean, logvar, x0p = self.p_mean_logvar(
                xt, t, eps, model_logvar_frac=frac, clip_x0=clip_x0)
            kl = _mean_rest(normal_kl(true_mean, true_logvar, mean, logvar)) / np.log(2.0)
            nll = -discretized_gaussian_log_likelihood(x0, mean, 0.5 * logvar)
            nll = _mean_rest(nll) / np.log(2.0)
            vbs.append(torch.where(t == 0, nll, kl))
            xms.append(_mean_rest((x0p - x0) ** 2))
            # eps recovered from the (possibly clipped) x0 prediction, as the
            # reference's _predict_eps_from_xstart does (:889)
            ab = self._g(self._ab, t, xt)
            eps_back = (xt - torch.sqrt(ab) * x0p) / torch.sqrt(1.0 - ab)
            mss.append(_mean_rest((eps_back - nz) ** 2))
        vb, xm, ms = (torch.stack(a, dim=1) for a in (vbs, xms, mss))   # (N, T)
        prior = self.prior_bpd(x0)
        return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior,
                "vb": vb, "xstart_mse": xm, "mse": ms}

    def vb_term(self, x0_true, xt, t, eps, model_logvar_frac=None):
        """Per-element VLB term L_{t-1} (or the L_0 decoder NLL) in
        bits/dim; the mean is detached so the term trains only the variance
        (training_losses :788)."""
        true_mean, true_logvar = self.q_posterior_mean_logvar(x0_true, xt, t)
        mean, logvar, _ = self.p_mean_logvar(
            xt, t, eps, model_logvar_frac=model_logvar_frac)
        mean = mean.detach()
        kl = _mean_rest(normal_kl(true_mean, true_logvar, mean, logvar)) / np.log(2.0)
        nll = -discretized_gaussian_log_likelihood(x0_true, mean, 0.5 * logvar)
        nll = _mean_rest(nll) / np.log(2.0)
        t = torch.as_tensor(t, device=kl.device)
        return torch.where(t == 0, nll, kl)


def hybrid_loss(math_: GaussianDiffusionMath, xt, t, noise, eps_pred,
                logvar_frac, x0_true, vb_weight: float = 1.0):
    """MSE on eps plus the weighted VLB on the learned variance (the
    reference's hybrid objective, gaussian_diffusion.py:744-817, rescaling
    left to the caller). Returns per-sample losses."""
    mse = _mean_rest((eps_pred - noise) ** 2)
    vb = math_.vb_term(x0_true, xt, t, eps_pred, model_logvar_frac=logvar_frac)
    return mse + vb_weight * vb

"""h-space (bottleneck) analysis utilities (port of
loco_edit_tpu/editing/hspace.py).

Counterparts of the reference PullBackDDPM's h-space methods (get_h,
get_h_to_e, inv_jac_xt, local_pca_xt, global_pca_xt) and the ADM get_h /
local encoder pullback: the encoder pullback finds x-space directions whose
images under d h / d x are the top singular directions; h_to_e measures how
a bottleneck perturbation moves the epsilon output. h_fn maps x_t to the
bottleneck feature, e.g. `lambda z: model(z, t, return_h=True)[-1]` (NHWC,
as the JAX package's). Each function runs on `device`: the card unless the
caller passes "cpu".
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from loco_edit_tpu_torch.core.device import resolve_device
from loco_edit_tpu_torch.editing.pullback import EditBasis, subspace_iteration


def local_encoder_pullback(h_fn: Callable, x: torch.Tensor, rng=None, *,
                           rank: int, device: str | torch.device = "cuda",
                           **kw) -> EditBasis:
    """Top right-singular directions of d h(x) / d x (subspace_iteration's
    keywords pass through: min_iter, max_iter, tol, v_init...)."""
    x = x.to(resolve_device(device))
    return subspace_iteration(h_fn, x, rng, rank=rank, **kw)


def h_to_e(eps_fn_with_inject: Callable, x: torch.Tensor, u_h: torch.Tensor,
           scale: float = 1.0, device: str | torch.device = "cuda") -> torch.Tensor:
    """Epsilon response to a bottleneck perturbation u_h:
    eps(x | h + scale*u_h) - eps(x) (the reference's get_h_to_e)."""
    dev = resolve_device(device)
    x, u_h = x.to(dev), u_h.to(dev)
    with torch.no_grad():
        return eps_fn_with_inject(x, scale * u_h) - eps_fn_with_inject(x, None)


def inv_jac(h_fn: Callable, x: torch.Tensor, u_h: torch.Tensor,
            perturb_h: float = 1e-1, device: str | torch.device = "cuda") -> torch.Tensor:
    """x-space directions realizing given h-space perturbations, the inverse
    Jacobian map (the reference's PullBackDDPM.inv_jac_xt).

    The reference perturbs h -> h + perturb_h*u and takes the gradient of
    x' -> ||(h + perturb_h*u) - h(x')|| at x, row-normalized. At x the
    residual is exactly perturb_h*u, so that gradient is -J_h^T u / ||u||
    for any perturb_h: one shared VJP of h_fn, vmapped over the rows; only
    the sign of perturb_h matters.

    u_h: (rank, d_h) rows (or (d_h,)); returns (rank, d_in) unit rows, f32.
    """
    dev = resolve_device(device)
    x = x.to(dev)
    u = torch.atleast_2d(torch.as_tensor(u_h, device=dev))
    h0, vjp_fn = torch.func.vjp(h_fn, x)
    sign = -float(np.sign(perturb_h))

    def one(ui):
        ct = (ui / torch.clamp(torch.linalg.norm(ui), min=1e-20)).reshape(h0.shape)
        return vjp_fn(sign * ct.to(h0.dtype))[0].reshape(-1).float()

    vT = torch.func.vmap(one)(u)
    return vT / torch.clamp(torch.linalg.norm(vT, dim=1, keepdim=True), min=1e-12)


def _top_components(centered: torch.Tensor, rank: int):
    """The top `rank` eigenvalues of the rows' (N, N) Gram, descending, and
    the matching components (rank, d), not yet normalized."""
    w, q = torch.linalg.eigh(centered @ centered.T)
    w, q = w.flip(0)[:rank], q.flip(1)[:, :rank]
    return w, q.T @ centered


def global_pca_h(h_fn: Callable, xs: torch.Tensor, *, rank: int, chunk: int = 0,
                 device: str | torch.device = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Global PCA of bottleneck features over a sample population (the
    reference's PullBackDDPM.global_pca_xt): (singular values (rank,),
    unit components (rank, d_h)).

    The population is small and d_h large, so the SVD goes through the
    (N, N) Gram eigendecomposition. With `chunk`, h is taken `chunk` samples
    a forward; the population is padded to a chunk multiple by wrapping and
    the padding dropped after, so every chunk has the same batch."""
    xs = xs.to(resolve_device(device))
    n = xs.shape[0]
    with torch.no_grad():
        if chunk and n > chunk:
            pad = (-n) % chunk
            xs_p = torch.cat([xs, xs[:pad]]) if pad else xs
            hs = torch.cat([h_fn(xs_p[i:i + chunk]).reshape(chunk, -1)
                            for i in range(0, xs_p.shape[0], chunk)])[:n]
        else:
            hs = h_fn(xs).reshape(n, -1)
    centered = (hs - hs.mean(dim=0, keepdim=True)).float()
    w, comps = _top_components(centered, rank)
    comps = comps / torch.clamp(torch.linalg.norm(comps, dim=1, keepdim=True), min=1e-12)
    return torch.sqrt(torch.clamp(w, min=0.0)), comps


def local_pca_h(h_fn: Callable, x: torch.Tensor, rng, *, rank: int,
                eps: float = 1e-2, n_probes: int = 64,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """PCA of bottleneck features under small input perturbations (the
    reference's local_pca_xt): (rank, d_h) unit components. The probes are
    one normal draw of (n_probes, *x.shape) from `rng` (an RngStream),
    scaled by eps, run as one batch."""
    x = x.to(resolve_device(device))
    probes = rng.normal((n_probes,) + tuple(x.shape), device=x.device, dtype=x.dtype) * eps
    with torch.no_grad():
        h0 = h_fn(x).reshape(-1)
        zs = (x[None] + probes).reshape(n_probes * x.shape[0], *x.shape[1:])
        hs = h_fn(zs).reshape(n_probes, -1)
    _, comps = _top_components((hs - h0[None]).float(), rank)
    return comps / torch.linalg.norm(comps, dim=1, keepdim=True)

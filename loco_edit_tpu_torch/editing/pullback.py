"""Matrix-free Jacobian subspace iteration (port of
loco_edit_tpu/editing/pullback.py).

Finds the top right-singular subspace of J = d f(x) / d x (f the posterior
mean predictor, optionally mask-weighted) without materializing J, by
alternating batched JVP / VJP sweeps with a small-Gram eigendecomposition.

How the JAX package's transforms map onto torch.func:
  - JAX linearizes once and reuses the linear map. torch.func has no
    `linearize` that can trace an opaque kernel launch, so each tangent sweep
    is `vmap(lambda v: jvp(f, (x,), (v,))[1])(V)`: x is unbatched, so the
    primal network (and each kernel) runs once per sweep for all probes,
    while the tangent network runs batched over the probes. That is one
    primal pass per sweep more than the JAX iteration pays.
  - The cotangent sweep takes `vjp(f, x)` once per basis and then
    `vmap(vjp_fn)(U)` each sweep, the counterpart of `jax.linear_transpose`.
  - Probes are not padded (the JAX package pads to 8 only on the TPU).
  - Probe sharding (`probe_mesh`, --mesh_probe): the JAX package pins the
    probe axis to a mesh and XLA splits the batched sweeps. Here each rank
    runs its equal share of the R (fused: 2R) probe JVPs and VJPs, the
    cotangent images are all-gathered after each sweep (an uneven split pads
    only the transport buffer, and its rows are dropped), and every rank does
    the same Gram eigh on the same bits, so every rank holds the basis.
  - The convergence early exit is a host loop that reads the movement of the
    iterate once min_iter sweeps have run.
  - Each pass of either loop is a `sweep` span with its device time; the
    convergence read and the eigh (which waits for the card) are readbacks
    (utils/logger.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from loco_edit_tpu_torch.core.device import to_device
from loco_edit_tpu_torch.parallel.collectives import gather_stack
from loco_edit_tpu_torch.utils.logger import readback, span


@dataclasses.dataclass
class EditBasis:
    """Result of a subspace iteration.

    u:  (rank, *out_shape) left images J v_i (mask-weighted, zeros off-mask)
    s:  (rank,) singular-value estimates of J (sqrt of the singular values
        of u^T J, as the reference returns)
    vT: (rank, d_in) right-singular directions, rows unit-norm
    iters: iterations executed
    """

    u: torch.Tensor
    s: torch.Tensor
    vT: torch.Tensor
    iters: int


def padded_probe_count(rank: int, d_in: int | None = None) -> int:
    """Probe-batch size an extraction executes for `rank`: no padding on the
    card, capped at the space dimension. The JAX package pads to the 8-sublane
    tile (lcm with the probe mesh) on the TPU only, so the port never pads,
    probe-sharded or not."""
    return rank if d_in is None else min(rank, d_in)


def _probe_share(n: int, probe_mesh) -> tuple[int, int, int]:
    """(lo, hi, per): this rank's rows [lo, hi) of n probes split over the
    probe mesh in equal shares of per rows (the last shares may be short or
    empty)."""
    per = -(-n // probe_mesh.size)
    lo = min(n, probe_mesh.coordinate(probe_mesh.axis_names[0]) * per)
    return lo, min(n, lo + per), per


def _gather_rows(local: torch.Tensor | None, n: int, per: int,
                 row_like: torch.Tensor, probe_mesh) -> torch.Tensor:
    """Every rank's share of n rows (local: this rank's, None when empty),
    padded to per rows for transport, gathered and cut back to n."""
    buf = row_like.new_zeros((per,) + tuple(row_like.shape))
    if local is not None:
        buf[:local.shape[0]] = local
    group = probe_mesh.group(probe_mesh.axis_names[0])
    return gather_stack(buf, group).reshape((-1,) + tuple(row_like.shape))[:n]


def init_probes(rng, rank: int, d_in: int, device) -> torch.Tensor:
    """Random orthonormal probe matrix (rank, d_in), f32: a standard normal
    draw from the stream `rng`, orthonormalized by modified Gram-Schmidt
    over the rank axis (the JAX package's init_probes)."""
    g = rng.normal((rank, d_in), device=device, dtype=torch.float32)
    rows = []
    for i in range(rank):
        v = g[i]
        for q in rows:
            v = v - torch.dot(q, v) * q
        rows.append(v / torch.linalg.norm(v))
    return torch.stack(rows)


def _map_chunks(fn, args, chunk: int | None):
    """vmap fn over the leading axis of every arg, optionally in chunks."""
    n = args[0].shape[0]
    if chunk is None or n <= chunk:
        return torch.func.vmap(fn)(*args)
    return torch.cat([torch.func.vmap(fn)(*(a[lo:lo + chunk] for a in args))
                      for lo in range(0, n, chunk)])


def _gram_update(vp: torch.Tensor, v: torch.Tensor):
    """One Gram step on (..., R, d) f32 cotangent images: new orthonormal
    iterate (sign-aligned to v) and singular values of vp, descending."""
    gram = vp @ vp.transpose(-1, -2)
    with readback():          # on a card, eigh waits for it (its error check)
        w, q = torch.linalg.eigh(gram)                 # ascending
    w, q = w.flip(-1), q.flip(-1)
    s_vp = torch.sqrt(torch.clamp(w, min=0.0))
    v_new = (q.transpose(-1, -2) @ vp) / torch.clamp(s_vp, min=1e-20)[..., None]
    dots = (v_new * v).sum(-1, keepdim=True)
    return v_new * torch.where(dots < 0, -1.0, 1.0), s_vp


def _keep_going(i: int, conv, min_iter: int, max_iter: int, tol: float) -> bool:
    if i >= max_iter:
        return False
    if i <= min_iter:
        return True
    with readback():
        return float(conv) > tol


def subspace_iteration(
    f: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    rng=None,
    *,
    rank: int,
    mask: torch.Tensor | None = None,
    min_iter: int = 10,
    max_iter: int = 50,
    tol: float = 1e-4,
    probe_chunk: int | None = None,
    v_init: torch.Tensor | None = None,
    probe_mesh=None,
) -> EditBasis:
    """Estimate the top-`rank` right-singular subspace of d f / d x at x.

    mask: optional 0/1 (or soft) weight broadcastable to f(x). probe_chunk:
    evaluate probes in chunks of this size to bound memory. v_init: explicit
    (rank, d_in) orthonormal starting probes (rows) instead of a draw from
    `rng`, for warm starts and matched-probe comparisons. probe_mesh: a
    one-axis core/mesh.py Mesh the probes are split over (every rank calls
    with the same arguments and gets the same basis).
    """
    d_in = x.numel()
    in_shape = x.shape
    r_eff = padded_probe_count(rank, d_in)

    def fw(z):
        y = f(z)
        return y if mask is None else y * mask.to(y.dtype)

    y0, vjp_fn = torch.func.vjp(fw, x)
    vrow = x.new_zeros((d_in,), dtype=torch.float32)
    if probe_mesh is not None:
        lo, hi, per = _probe_share(r_eff, probe_mesh)

    def one_u(vi):
        return torch.func.jvp(fw, (x,), (vi.reshape(in_shape).to(x.dtype),))[1]

    def one_v(ui):
        return vjp_fn(ui)[0].reshape(d_in).float()

    if v_init is not None:
        v = torch.as_tensor(v_init, dtype=torch.float32, device=x.device)
        if v.shape != (r_eff, d_in):
            raise ValueError(f"v_init shape {tuple(v.shape)} != ({r_eff}, {d_in})")
    else:
        v = init_probes(rng, r_eff, d_in, x.device)
    i, conv, u, s_vp = 0, float("inf"), None, None
    while _keep_going(i, conv, min_iter, max_iter, tol):
        with span("sweep", device=x.is_cuda):
            if probe_mesh is None:
                u = _map_chunks(one_u, (v,), probe_chunk)      # u = J v
                vp = _map_chunks(one_v, (u,), probe_chunk)     # vp = u^T J
            else:                                              # this rank's share
                u = _map_chunks(one_u, (v[lo:hi],), probe_chunk) if hi > lo else None
                vp_loc = _map_chunks(one_v, (u,), probe_chunk) if hi > lo else None
                vp = _gather_rows(vp_loc, r_eff, per, vrow, probe_mesh)
            v_new, s_vp = _gram_update(vp, v)
            conv = (v_new[:rank] - v[:rank]).abs().max()
        v, i = v_new, i + 1
    if probe_mesh is not None:
        u = _gather_rows(u, r_eff, per, y0, probe_mesh)
    return EditBasis(u=u[:rank], s=torch.sqrt(s_vp[:rank]), vT=v[:rank],
                     iters=i)


def dual_subspace_iteration(
    f: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    rng_a=None,
    rng_b=None,
    *,
    rank_a: int,
    rank_b: int,
    mask_a: torch.Tensor,
    mask_b: torch.Tensor,
    min_iter: int = 10,
    max_iter: int = 50,
    tol: float = 1e-4,
    probe_chunk: int | None = None,
    v_init: torch.Tensor | None = None,
    probe_mesh=None,
) -> tuple[EditBasis, EditBasis]:
    """Two mask-weighted subspace iterations on the SAME Jacobian, fused.

    The mask basis and the complement-mask basis differ only in the output
    weight, so both probe groups share one vjp and run as one batch of 2R
    probes per sweep, with per-probe masks: u_i = m_g * (J v_i) and
    v'_i = J^T (m_g * u_i), exactly what `subspace_iteration(mask=m_g)`
    computes. The Gram / eigh / convergence steps are blockwise per group;
    the loop exits when both groups converge. v_init: explicit (2, R, d_in)
    starting probes instead of draws from rng_a / rng_b. probe_mesh: the
    2R probes split over a one-axis mesh, as in subspace_iteration.
    Returns (basis_a, basis_b).
    """
    d_in = x.numel()
    in_shape = x.shape
    R = max(padded_probe_count(rank_a, d_in), padded_probe_count(rank_b, d_in))

    y0, vjp_fn = torch.func.vjp(f, x)
    out_shape = y0.shape
    m = torch.stack([torch.broadcast_to(mask_a.float(), out_shape),
                     torch.broadcast_to(mask_b.float(), out_shape)])
    m_flat = m.repeat_interleave(R, dim=0)              # (2R, *out)

    def one_u(vi, mi):
        y = torch.func.jvp(f, (x,), (vi.reshape(in_shape).to(x.dtype),))[1]
        return y * mi.to(y.dtype)

    def one_v(ui, mi):
        return vjp_fn(ui * mi.to(ui.dtype))[0].reshape(d_in).float()

    if v_init is not None:
        v = torch.as_tensor(v_init, dtype=torch.float32, device=x.device)
        if v.shape != (2, R, d_in):
            raise ValueError(f"v_init shape {tuple(v.shape)} != (2, {R}, {d_in})")
    else:
        v = torch.stack([init_probes(rng_a, R, d_in, x.device),
                         init_probes(rng_b, R, d_in, x.device)])
    row_w = to_device(torch.stack([(torch.arange(R) < rank_a), (torch.arange(R) < rank_b)]),
                      x.device)
    if probe_mesh is not None:
        lo, hi, per = _probe_share(2 * R, probe_mesh)
        vrow = x.new_zeros((d_in,), dtype=torch.float32)
    i, conv, u, s_vp = 0, float("inf"), None, None
    while _keep_going(i, conv, min_iter, max_iter, tol):
        with span("sweep", device=x.is_cuda):
            v_flat = v.reshape(2 * R, d_in)
            if probe_mesh is None:
                u = _map_chunks(one_u, (v_flat, m_flat), probe_chunk)
                vp = _map_chunks(one_v, (u, m_flat), probe_chunk)
            else:                                              # this rank's share
                u = (_map_chunks(one_u, (v_flat[lo:hi], m_flat[lo:hi]), probe_chunk)
                     if hi > lo else None)
                vp_loc = (_map_chunks(one_v, (u, m_flat[lo:hi]), probe_chunk)
                          if hi > lo else None)
                vp = _gather_rows(vp_loc, 2 * R, per, vrow, probe_mesh)
            v_new, s_vp = _gram_update(vp.reshape(2, R, d_in), v)
            conv = ((v_new - v).abs() * row_w[..., None]).max()
        v, i = v_new, i + 1
    if probe_mesh is not None:
        u = _gather_rows(u, 2 * R, per, y0, probe_mesh)
    u = u.reshape(2, R, *out_shape)

    def basis(g, rank):
        return EditBasis(u=u[g, :rank], s=torch.sqrt(s_vp[g, :rank]),
                         vT=v[g, :rank], iters=i)

    return basis(0, rank_a), basis(1, rank_b)


def pmp_pullback_fn(eps_fn, alpha_bar_t, t) -> Callable[[torch.Tensor], torch.Tensor]:
    """f(x) = PMP(x, t) for a bound denoiser: the map the subspace iteration
    differentiates."""
    from loco_edit_tpu_torch.diffusion.scheduler import pmp

    def f(x):
        return pmp(x, eps_fn(x, t), alpha_bar_t)

    return f


def eps_pullback_fn(eps_fn, t) -> Callable[[torch.Tensor], torch.Tensor]:
    """f(x) = eps(x, t): the `encoder_decoder_by_et` variant."""
    return lambda x: eps_fn(x, t)

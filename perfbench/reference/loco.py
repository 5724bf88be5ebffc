"""Plain LOCO-Edit, the reference the benchmark judges served edits by.

Everything here is written from the method's definition in plain float32
`torch` and numpy, and imports nothing of the program:

- the random draws. The request names x_T by a seed, and the served
  edit draws its probes and its eta noise from named streams of the
  server's seed. The rule that turns a seed and a stream name into a
  `torch.Generator` seed (blake2b of the name, mixed with the parent's
  seed) is part of the edit's definition. So the reference derives the same
  streams from the same seeds and draws the same normals on the same
  device;
- the linspace DDIM grid over the linear beta schedule, the DDIM update
  and the posterior-mean predictor (PMP);
- the masked Jacobian subspace iteration of the PMP (a fixed number of
  sweeps of batched J v and J^T u with a Gram eigendecomposition), the
  mask's basis and its complement's, each from its own probe stream and
  rank;
- null-space projection, the x-space walk strip and the uint8 pixels.

`tf32_round` is the precision control: the reference computed with every
product's operands rounded to TF32, the precision below float32 with TF32
off, which the configurations state.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# -- the random streams ---------------------------------------------------------


def _name_hash(name: str) -> int:
    return int.from_bytes(hashlib.blake2b(name.encode(), digest_size=4).digest(), "big")


def _mix(seed: int, data: int) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(seed.to_bytes(8, "little") + int(data).to_bytes(8, "little"))
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


class Stream:
    """A named stream of standard normal draws rooted at an integer seed."""

    def __init__(self, seed: int):
        self.seed = seed

    @classmethod
    def root(cls, seed: int) -> "Stream":
        return cls(_mix(0, seed))

    def fork(self, name: str) -> "Stream":
        return Stream(_mix(self.seed, _name_hash(name)))

    def at_step(self, step: int) -> "Stream":
        return Stream(_mix(self.seed, step))

    def normal(self, shape, device) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(self.seed)
        return torch.randn(tuple(shape), generator=g, device=device, dtype=torch.float32)


# -- the DDIM grid and update ---------------------------------------------------


def _linspace_f32(n: int) -> np.ndarray:
    """torch.linspace(0, 1, n) in float32, as the grid is defined."""
    if n == 1:
        return np.zeros((1,), np.float64)
    i = np.arange(n)
    step = np.float64(np.float32(1.0) / np.float32(n - 1))
    fwd = (i * step).astype(np.float32)
    bwd = (np.float64(1.0) - (n - 1 - i) * step).astype(np.float32)
    return np.where(i < n // 2, fwd, bwd).astype(np.float64)


class Grid:
    """The descending generation grid of `steps` DDIM steps over t in
    [0, 999] on the linear beta schedule (1e-4 to 0.02 over 1000 steps):
    per executed update its model timestep t and the alpha-bars at floor(t)
    and at floor(t_next), in float32."""

    def __init__(self, steps: int, t_max: int = 999):
        ab = np.cumprod(1.0 - np.linspace(1e-4, 0.02, 1000, dtype=np.float64))
        g = (_linspace_f32(steps).astype(np.float32) * np.float32(t_max)).astype(np.float64)
        t, t_next = g[1:][::-1], g[:-1][::-1]

        def look(v):
            return ab[np.clip(v.astype(np.int64), 0, 999)].astype(np.float32)

        self.t = t.astype(np.float32)
        self.ab, self.ab_next = look(t), look(t_next)

    def __len__(self) -> int:
        return len(self.t)

    def index_of(self, t_frac: float) -> int:
        return int(np.argmin(np.abs(self.t - t_frac * 1000.0)))

    def boost_eta(self, boost_frac: float) -> np.ndarray:
        """eta 1 from the step nearest boost_frac on, unless that is the last."""
        eta = np.zeros((len(self),), np.float32)
        if boost_frac > 0:
            b = self.index_of(boost_frac)
            if b != len(self) - 1:
                eta[b:] = 1.0
        return eta


def ddim_update(x, eps, ab, ab_next, eta=0.0, noise=None):
    """x_t -> x_next: x0 = (x - sqrt(1-ab) eps) / sqrt(ab); x_next = sqrt(ab_next)
    x0 + sqrt(1 - ab_next - sigma^2) eps + sigma noise, with the DDIM sigma
    at eta; coefficients formed in float32."""
    f = np.float32
    ab, ab_next, eta = f(ab), f(ab_next), f(eta)
    var = (f(1) - ab / ab_next) * (f(1) - ab_next) / (f(1) - ab)
    sigma = eta * np.sqrt(np.maximum(var, f(0)))
    d = np.sqrt(np.maximum(f(1) - ab_next - sigma * sigma, f(0)))
    x0 = (x - eps * float(np.sqrt(f(1) - ab))) / float(np.sqrt(ab))
    out = x0 * float(np.sqrt(ab_next)) + eps * float(d)
    return out if noise is None else out + noise * float(sigma)


def pmp(x, eps, ab):
    """The posterior mean predictor x0_hat(x_t)."""
    f = np.float32
    return (x - eps * float(np.sqrt(f(1) - f(ab)))) / float(np.sqrt(f(ab)))


@torch.no_grad()
def denoise(eps_fn, x, grid: Grid, start: int, end: int, *, eta=None, stream=None):
    """DDIM steps [start, end) of the grid from x. With eta, the noise of
    executed step i (counted from start) is stream.at_step(i)'s draw for the
    whole batch."""
    for j, i in enumerate(range(start, end)):
        eps = eps_fn(x, float(grid.t[i]))
        noise = None
        if eta is not None and eta[i] > 0:
            noise = stream.at_step(j).normal(tuple(x.shape), x.device)
        x = ddim_update(x, eps, grid.ab[i], grid.ab_next[i],
                        0.0 if eta is None else eta[i], noise)
    return x


# -- the masked Jacobian subspace iteration ---------------------------------------


def init_probes(stream: Stream, rank: int, d: int, device) -> torch.Tensor:
    """Orthonormal (rank, d) probes: a normal draw, modified Gram-Schmidt."""
    g = stream.normal((rank, d), device)
    rows = []
    for i in range(rank):
        v = g[i]
        for q in rows:
            v = v - torch.dot(q, v) * q
        rows.append(v / torch.linalg.norm(v))
    return torch.stack(rows)


def _gram_step(vp, v):
    w, q = torch.linalg.eigh(vp @ vp.transpose(-1, -2))
    w, q = w.flip(-1), q.flip(-1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    v_new = (q.transpose(-1, -2) @ vp) / torch.clamp(s, min=1e-20)[..., None]
    dots = (v_new * v).sum(-1, keepdim=True)
    return v_new * torch.where(dots < 0, -1.0, 1.0)


def masked_basis(f, x, mask, probes, sweeps: int):
    """The mask's top right-singular subspace of J = df/dx at x, from the
    given (R, d) orthonormal probes, after `sweeps` sweeps of
    v <- orth(J^T (m * (m * J v))). Returns (R, d)."""
    d = x.numel()
    shape = x.shape
    _, vjp_fn = torch.func.vjp(f, x)

    def one_u(vi):
        return torch.func.jvp(f, (x,), (vi.reshape(shape),))[1] * mask

    def one_v(ui):
        return vjp_fn(ui * mask)[0].reshape(d)

    v = probes
    for _ in range(sweeps):
        v = _gram_step(torch.func.vmap(one_v)(torch.func.vmap(one_u)(v)), v)
    return v


def edit_basis(f, x, mask, probes, probes_null, sweeps: int):
    """The edit's directions: the mask's basis from `probes`, without its
    part in the span of the complement's basis from `probes_null` (each
    rank its own probe count; a program may fuse the two iterations when
    the counts agree, which computes the same)."""
    return null_space_project(masked_basis(f, x, mask, probes, sweeps),
                              masked_basis(f, x, 1 - mask, probes_null, sweeps))


def normalize_rows(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True), min=eps)


def null_space_project(v_mod, v_null):
    """Rows of v_mod without their part in the span of v_null's rows, unit norm."""
    return normalize_rows(v_mod - (v_null.T @ (v_null @ v_mod.T)).T)


# -- strips and pixels --------------------------------------------------------------


def walk_offsets(scale: float, edit_step: float, num_steps: int, vis_num: int) -> np.ndarray:
    """The walk coefficient of each frame of one strip: the mirrored walk
    k * scale * edit_step for k = 0..num_steps, subsampled to every
    (num_steps + 1) // vis_num-th step ([0, num_steps] when vis_num is 1),
    negative side first, the centre once."""
    n = num_steps + 1
    idx = (np.array([0, n - 1]) if vis_num == 1
           else np.arange(0, n, max(n // vis_num, 1)))
    ks = np.arange(n, dtype=np.float32)[idx] * np.float32(scale * edit_step)
    return np.concatenate([-ks[::-1][:-1], ks])


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 pixels, rounding half up."""
    return torch.floor(torch.clamp(x.float() / 2 + 0.5, 0, 1) * 255 + 0.5).to(torch.uint8)


def pixel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 distance of two uint8 frame stacks, on the [-1, 1] scale."""
    a = got.double() / 127.5 - 1
    b = want.double() / 127.5 - 1
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def subspace_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """1 - the mean squared cosine of the principal angles between the row
    spans of a and b (0: the same span; 1: orthogonal). Rows need not be
    orthonormal."""
    qa = torch.linalg.qr(a.double().T).Q
    qb = torch.linalg.qr(b.double().T).Q
    cos = torch.linalg.svdvals(qa.T @ qb)
    return float(1 - (cos ** 2).mean())


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """t's float32 values rounded to TF32 (10 explicit mantissa bits, to
    nearest, ties to even), as a TF32 tensor core takes its operands; the
    same bits on every device. Derivatives pass straight through the
    rounding."""
    b = t.detach().float().contiguous().view(torch.int32)
    r = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return t + (r.view(torch.float32).to(t.dtype) - t).detach()

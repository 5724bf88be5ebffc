"""A CPU model of the f32 attention kernel's arithmetic (csrc/flash_attention.cu,
namespace tf32x3): every product split into TF32 hi and lo parts and run as
three 8-deep MMAs, online softmax over the kernel's key tiles, one final
division. It is held to the plain version (and through it to the JAX
package's XLA attention) within the f32 tolerance the card's checks use,
and the designs it replaced or rejected, one TF32 product and a split that
leaves hi to the MMA's truncation, are shown to miss that tolerance."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.ops.attention import _xla_attention
from loco_edit_tpu_torch.ops.flash_attention import (F32_ROWS_MAX_D, HEAD_DIMS, F32Geometry,
                                                     _scale, attention_plain,
                                                     kernel_geometry, route)

torch.set_num_threads(2)


def f32_attn_tol(ref: torch.Tensor) -> float:
    """chip_smoke.py's and the card tests' f32 attention tolerance: 5e-5,
    tightened to 2^-13 of the largest |output| where that is smaller (at
    4096 keys the outputs are ~0.1 and one TF32 rounding lands ~4e-4 of
    them off, under 5e-5)."""
    return min(5e-5, 2 ** -13 * ref.abs().max().item())


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 by bit masking: round the f32 significand to 10
    bits, ties away from zero (finite inputs)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the MMA reads of an unrounded f32 register: its low 13 bits
    dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor, design: str):
    """(hi, lo) as the kernel feeds the MMAs; lo None where it is zero."""
    if design == "3xtf32":
        hi = tf32_rna(x)
        return hi, tf32_rna(x - hi)
    if design == "1xtf32":
        return tf32_rna(x), None
    if design == "no-cvt":      # hi = x unrounded (truncated by the MMA), lo = x - hi = 0
        return tf32_trunc(x), None
    raise ValueError(design)


def _mma_product(a, b, design, chunks=1):
    """a (..., M, K) @ b (..., K, N) as the kernel forms it: 8-deep k-steps
    accumulated in f32, each step lo*hi, hi*lo, then hi*hi; the depth cut
    into `chunks` equal partials (one per warp) summed in order."""
    ah, al = _split(a, design)
    bh, bl = _split(b, design)
    depth = a.shape[-1] // chunks
    total = None
    for c0 in range(0, a.shape[-1], depth):
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
        for k0 in range(c0, c0 + depth, 8):
            ks = slice(k0, k0 + 8)
            if al is not None:
                acc = acc + al[..., ks] @ bh[..., ks, :]
                acc = acc + ah[..., ks] @ bl[..., ks, :]
            acc = acc + ah[..., ks] @ bh[..., ks, :]
        total = acc if total is None else total + acc
    return total


def f32_kernel_model(q, k, v, design="3xtf32"):
    """The kernel's arithmetic in plain torch at its f32 geometry: q * s and
    k * s in f32 (s = d^-1/4), S = Q K^T per key tile (the "cols" route
    sums its warps' partials), online softmax over the tiles, unnormalized
    P times V with the same split, one f32 division by the row sum."""
    d = q.shape[-1]
    geo = kernel_geometry(d, torch.float32)
    chunks = 1 if geo.cols == d else geo.warps
    s = _scale(d)
    qs, ks = q * s, k * s
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + v.shape[-1:])
    for j0 in range(0, k.shape[-2], geo.block_k):
        kt, vt = ks[..., j0:j0 + geo.block_k, :], v[..., j0:j0 + geo.block_k, :]
        pad = geo.block_k - kt.shape[-2]        # the zero-filled ragged last tile
        if pad:
            kt, vt = (torch.cat([t, t.new_zeros(*t.shape[:-2], pad, d)], -2) for t in (kt, vt))
        logits = _mma_product(qs, kt.transpose(-1, -2), design, chunks)
        if pad:
            logits[..., geo.block_k - pad:] = -math.inf
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mma_product(p, vt, design)
        m = m_new
    return acc / l


def _inputs(seed, b, h, nq, nkv, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
                 for n in (nq, nkv, nkv))


# (B, H, N_q, N_kv, D): small self- and cross-attention, then 4096 keys (the
# SD / LCM latent, the VAE's single head), a slice of the query rows each
F32_MODEL_SHAPES = [(2, 2, 77, 77, 40), (1, 2, 64, 64, 64), (1, 2, 50, 77, 64),
                    (1, 1, 64, 256, 512), (1, 2, 64, 4096, 40), (1, 2, 64, 4096, 64),
                    (1, 1, 32, 4096, 512)]


@pytest.mark.parametrize("shape", F32_MODEL_SHAPES)
def test_3xtf32_model_within_f32_tolerance_and_one_tf32_product_is_not(shape):
    """The 3xTF32 model agrees with attention_plain within f32_attn_tol
    (itself within 5e-5) at every shape, with more than 10x to spare; one
    TF32 product (hi only) and a split that leaves hi to the MMA's
    truncation (lo = x - hi = 0) each miss it, at the 4096-key shapes
    too, where 5e-5 alone would pass the 1xTF32 kernel at D = 512."""
    q, k, v = _inputs(30 + shape[-1], *shape)
    ref = attention_plain(q, k, v)
    tol = f32_attn_tol(ref)
    assert tol <= 5e-5
    err = {design: (f32_kernel_model(q, k, v, design) - ref).abs().max().item()
           for design in ("3xtf32", "1xtf32", "no-cvt")}
    assert err["3xtf32"] <= tol / 10, err
    assert err["1xtf32"] > tol and err["no-cvt"] > tol, (err, tol)


@pytest.mark.parametrize("shape", F32_MODEL_SHAPES[:4])
def test_3xtf32_model_matches_jax_xla_attention(shape):
    """The same inputs through the JAX package's XLA attention at f32 and
    through the model of the kernel: within f32_attn_tol."""
    q, k, v = _inputs(40 + shape[-1], *shape)
    ref = torch.from_numpy(np.asarray(_xla_attention(*(jnp.asarray(t.numpy())
                                                       for t in (q, k, v)))))
    got = f32_kernel_model(q, k, v)
    assert (got - ref).abs().max().item() <= f32_attn_tol(ref)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_kernel_geometry_covers_every_head_dim(d):
    """csrc/flash_attention.cu's f32 tiling (mirrored by kernel_geometry):
    8-deep k-steps and 8-wide n-tiles that cover D without padding; up to
    F32_ROWS_MAX_D 4 warps of 16 rows that own all D columns, above it warps
    that each take D / warps of the depth and of the columns (S once per
    tile); the shared memory of tf32x3::Rows (raw and split tiles, both
    double-buffered; Q split in shared memory at D = 80) / Cols under the
    227 KB opt-in limit and two blocks an SM where the rows split has it,
    row strides that keep the fragment loads free of bank conflicts, whole
    split steps a thread, and the route's name."""
    geo = kernel_geometry(d, torch.float32)
    assert isinstance(geo, F32Geometry) and d % 8 == 0 and geo.cols % 8 == 0
    if d <= F32_ROWS_MAX_D:
        assert geo == (4, 64, 32 if d <= 64 else 16, d)
        assert route(torch.float32, d) == "f32-3xtf32"
        pairs = d // 2 + (12 - d // 2 % 8) % 8       # K tile row, float4 units
        assert pairs % 8 == 4 and pairs >= d // 2
        assert geo.block_k * d // 2 % 128 == 0       # whole split steps
        split = (geo.block_k * pairs + d * geo.block_k // 2) * 16
        assert geo.block_q * (d + 4) * 4 <= 2 * split   # Q is staged in the split tiles
        smem = 4 * geo.block_k * (d + 4) * 4 + 2 * split + (0 if d <= 64 else 64 * pairs * 16)
        assert 2 * (smem + 1024) <= 233472              # two blocks an SM
    else:
        assert geo.block_q == 32 and geo.block_k == 16 and geo.cols * geo.warps == d
        assert geo.warps == (8 if d >= 256 else d // 32) and geo.warps >= geo.block_q // 16
        assert route(torch.float32, d) == f"f32-3xtf32-{geo.warps}x{geo.cols}-cols"
        assert (d + 8) % 32 == 8 and (d + 4) % 16 == 4
        smem = ((geo.block_q + 2 * geo.block_k) * (d + 8) + 2 * geo.block_k * (d + 4)) * 4 \
            + (geo.warps * 2 * 2 * 32 + 2 * 2 * 2 * 32) * 16 + 2 * geo.block_q * 4
    assert smem <= 232448


def test_tf32_rounding_by_bit_masking():
    """tf32_rna rounds to nearest on 10 mantissa bits with ties away from
    zero, on both signs and across a binade; truncation drops the bits."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp * 0.49, 1 + one_ulp * 0.5, -(1 + one_ulp * 0.51),
                      2 - one_ulp * 0.25, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + one_ulp, -(1 + one_ulp), 2.0, 3.0])
    assert torch.equal(tf32_rna(x), want)
    assert torch.equal(tf32_trunc(x), torch.tensor([1.0, 1.0, -1.0, 2 - one_ulp, 3.0]))
    hi = tf32_rna(x)
    assert ((x - hi - tf32_rna(x - hi)).abs() <= 2.0 ** -22 * x.abs()).all()

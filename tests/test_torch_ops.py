"""The port's GroupNorm and attention (plain versions and autograd rules)
against the JAX package: its XLA paths, its Pallas kernels in interpret
mode, and jax.jvp / jax.vjp of the same functions."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from loco_edit_tpu.ops.attention import _lean_attention, _xla_attention
from loco_edit_tpu.ops.norms import group_norm_f32 as jax_gn
from loco_edit_tpu_torch.ops.flash_attention import (SLICE, AttentionFn, AttnGeometry,
                                                     _kernel_layout, _scale,
                                                     attention_plain, kernel_geometry)
from loco_edit_tpu_torch.ops.groupnorm import (GroupNormFn, group_norm_plain,
                                               launch_geometry)
from loco_edit_tpu_torch.ops.norms import group_norm_f32
from _torch_p2_shapes import P2_ATTN_SHAPES, P2_GN_SHAPES, p2_call_shapes
from _torch_sd_shapes import (SD_DEC_GN_SHAPES, SD_ENC_GN_SHAPES, SD_UNET_ATTN_SHAPES,
                              SD_UNET_GN_SHAPES)
from _torch_port_utils import nchw, nhwc

torch.set_num_threads(2)


def _gn_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    return (x, (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            (0.1 * rng.normal(size=c)).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (1, 4, 6, 64), (2, 4, 4, 96),
                                   (1, 2, 2, 128)])
def test_group_norm_matches_jax_f32(shape):
    """f32: agreement to float-rounding of two summation orders (atol 1e-5
    on O(1) outputs)."""
    x, s, b = _gn_inputs(0, shape)
    ref = np.asarray(jax_gn(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = group_norm_f32(nchw(x), torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got), ref, atol=1e-5)


def test_group_norm_matches_jax_bf16():
    """bf16 input, f32 statistics, bf16 output: one bf16 rounding of the same
    f32 value, so at most one bf16 ulp apart (rtol 2^-7, atol 1e-2)."""
    x, s, b = _gn_inputs(1, (2, 8, 8, 64))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jax_gn(xb, jnp.asarray(s), jnp.asarray(b)), np.float32)
    xt = nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = group_norm_f32(xt, torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), ref, rtol=2 ** -7, atol=1e-2)


def test_group_norm_matches_pallas_stats_kernel():
    """GroupNorm formed from the Pallas one-pass statistics (interpret mode,
    as tests/test_pallas_gn_stats.py runs it) equals the port's (atol 1e-5)."""
    from loco_edit_tpu.ops.pallas.groupnorm_stats import _stats_kernel

    x, s, b = _gn_inputs(2, (2, 8, 4, 64))
    bsz, h, w, c = x.shape
    ps, pss = pl.pallas_call(
        _stats_kernel, grid=(bsz, h // 2),
        in_specs=[pl.BlockSpec((1, 2, w, c), lambda i, j: (i, j, 0, 0))],
        out_specs=(pl.BlockSpec((bsz, c), lambda i, j: (0, 0)),
                   pl.BlockSpec((bsz, c), lambda i, j: (0, 0))),
        out_shape=(jax.ShapeDtypeStruct((bsz, c), jnp.float32),
                   jax.ShapeDtypeStruct((bsz, c), jnp.float32)),
        interpret=True)(jnp.asarray(x))
    g, cg, n = 32, c // 32, h * w * (c // 32)
    sg = np.asarray(ps).reshape(bsz, g, cg).sum(-1)
    ssg = np.asarray(pss).reshape(bsz, g, cg).sum(-1)
    mean = sg / n
    rstd = 1 / np.sqrt(np.maximum(ssg / n - mean ** 2, 0) + 1e-5)
    ref = ((x - np.repeat(mean, cg, 1)[:, None, None]) * np.repeat(rstd, cg, 1)[:, None, None]
           * s + b)
    got = group_norm_plain(nchw(x), torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(got), ref, atol=1e-5)


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(dtype) for _ in range(3))


@pytest.mark.parametrize("shape", [(2, 3, 64, 32), (1, 2, 20, 16)])
def test_attention_matches_xla_f32(shape):
    q, k, v = _qkv(3, shape)
    ref = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v))))
    got = attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6)


def test_attention_matches_xla_bf16():
    """bf16 in and out, f32 softmax: within two bf16 ulps (atol 2e-2)."""
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in _qkv(4, (1, 2, 64, 32)))
    ref = np.asarray(_xla_attention(q, k, v), np.float32)
    qt, kt, vt = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
                  for a in (q, k, v))
    got = AttentionFn.apply(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2)


def test_attention_matches_pallas_flash_kernel():
    """The Pallas flash kernel in interpret mode (as
    tests/test_pallas_attention.py runs it) against the port (atol 3e-5)."""
    from loco_edit_tpu.ops.pallas.flash_attention import _flash_kernel

    q, k, v = _qkv(5, (1, 2, 128, 32))
    b, h, n, d = q.shape
    flat = [jnp.asarray(a.reshape(b * h, n, d)) for a in (q, k, v)]
    out = pl.pallas_call(
        functools.partial(_flash_kernel, scale=1.0 / math.sqrt(math.sqrt(d)),
                          block_k=32),
        grid=(b * h, n // 64),
        in_specs=[pl.BlockSpec((1, 64, d), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((1, n, d), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((1, n, d), lambda i, j: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, 64, d), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((b * h, n, d), jnp.float32),
        interpret=True)(*flat)
    got = AttentionFn.apply(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(out).reshape(q.shape),
                               atol=3e-5)


# -- differentiation rules under vmap, against jax.jvp / jax.vjp ----------------

def _probes(seed, n, shape):
    return np.random.default_rng(seed).normal(size=(n,) + shape).astype(np.float32)


def test_group_norm_jvp_vjp_vmap_match_jax():
    """torch.func.jvp / vjp of GroupNormFn with the probe axis vmapped, x
    unbatched (the subspace iteration's pattern), against jax.jvp / jax.vjp
    of group_norm_f32 in f32 (atol 2e-5); the jvp also with tangents on the
    affine parameters."""
    x, s, b = _gn_inputs(6, (2, 4, 4, 64))
    tan = _probes(7, 3, x.shape)
    cot = _probes(8, 3, x.shape)
    ts, tb = _probes(18, 3, s.shape), _probes(19, 3, b.shape)
    J = jnp.asarray
    jv = jax.vmap(lambda t: jax.jvp(lambda z: jax_gn(z, J(s), J(b)), (J(x),), (t,))[1])(J(tan))
    jv3 = jax.vmap(lambda t, u, w: jax.jvp(jax_gn, (J(x), J(s), J(b)), (t, u, w))[1])(
        J(tan), J(ts), J(tb))
    _, pull = jax.vjp(lambda z: jax_gn(z, J(s), J(b)), J(x))
    vj = jax.vmap(lambda c: pull(c)[0])(J(cot))

    T = torch.from_numpy
    xt, tant = nchw(x), T(tan).permute(0, 1, 4, 2, 3)
    ft = lambda z: GroupNormFn.apply(z, T(s), T(b), 32, 1e-5)    # noqa: E731
    tjv = torch.func.vmap(lambda t: torch.func.jvp(ft, (xt,), (t,))[1])(tant)
    tjv3 = torch.func.vmap(lambda t, u, w: torch.func.jvp(
        lambda z, ss, bb: GroupNormFn.apply(z, ss, bb, 32, 1e-5),
        (xt, T(s), T(b)), (t, u, w))[1])(tant, T(ts), T(tb))
    _, tpull = torch.func.vjp(ft, xt)
    tvj = torch.func.vmap(lambda c: tpull(c)[0])(T(cot).permute(0, 1, 4, 2, 3))
    for got, ref in ((tjv, jv), (tjv3, jv3), (tvj, vj)):
        np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), np.asarray(ref),
                                   atol=2e-5)


def test_group_norm_param_grads_match_autograd():
    """The backward rule's scale/bias grads equal autograd of the plain
    formula (atol 1e-4 on sums of 128 O(1) terms)."""
    x, s, b = _gn_inputs(9, (2, 4, 4, 64))
    g = torch.from_numpy(_probes(10, 1, (2, 64, 4, 4))[0])
    grads = []
    for fn in (lambda *a: GroupNormFn.apply(*a, 32, 1e-5), group_norm_plain):
        xs, ss, bs = (torch.from_numpy(a).requires_grad_() for a in
                      (x.transpose(0, 3, 1, 2).copy(), s, b))
        torch.autograd.backward(fn(xs, ss, bs), g)
        grads.append([t.grad for t in (xs, ss, bs)])
    for a, b_ in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-4)


def test_attention_jvp_vjp_vmap_match_jax_lean():
    """The lean rule and its transpose under vmap against jax.jvp / jax.vjp
    of _lean_attention, f32 (atol 5e-6, the JAX package's own tolerance for
    the rule in tests/test_attention_jvp.py)."""
    q, k, v = _qkv(11, (2, 3, 24, 16))
    tq, tk, tv = (_probes(12 + i, 4, q.shape) for i in range(3))
    cot = _probes(15, 4, q.shape)
    J = lambda a: jnp.asarray(a)                                  # noqa: E731
    jv = jax.vmap(lambda a, b, c: jax.jvp(_lean_attention, (J(q), J(k), J(v)),
                                          (a, b, c))[1])(J(tq), J(tk), J(tv))
    _, pull = jax.vjp(_lean_attention, J(q), J(k), J(v))
    vj = jax.vmap(pull)(J(cot))

    T = torch.from_numpy
    tjv = torch.func.vmap(lambda a, b, c: torch.func.jvp(
        AttentionFn.apply, (T(q), T(k), T(v)), (a, b, c))[1])(T(tq), T(tk), T(tv))
    _, tpull = torch.func.vjp(AttentionFn.apply, T(q), T(k), T(v))
    tvj = torch.func.vmap(tpull)(T(cot))
    np.testing.assert_allclose(tjv.numpy(), np.asarray(jv), atol=5e-6)
    for a, b in zip(tvj, vj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-6)


def test_vmap_rules_fold_into_batch():
    """Vmapping the Functions' forward calls the vmap rule, which folds the
    vmapped dim into the batch and equals a per-sample loop exactly."""
    x, s, b = _gn_inputs(16, (2, 4, 4, 32))
    xs = torch.stack([nchw(x), nchw(x * 0.5)])
    st, bt = torch.from_numpy(s), torch.from_numpy(b)
    got = torch.func.vmap(lambda z: GroupNormFn.apply(z, st, bt, 32, 1e-5))(xs)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), GroupNormFn.apply(xs[i], st, bt, 32, 1e-5).numpy())
    q, k, v = map(torch.from_numpy, _qkv(17, (3, 2, 2, 16, 16)))
    got = torch.func.vmap(AttentionFn.apply, in_dims=(0, 0, None))(q, k, v[0])
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(),
                                   attention_plain(q[i], k[i], v[0]).numpy(), atol=1e-6)


# -- models of the CUDA kernels' arithmetic and launch geometry -----------------

def test_p2_call_shapes_match_the_model():
    """The P2 call shapes the card's tests and chip_smoke.py rely on are the
    ones a FFHQ_P2 forward makes (65 GroupNorm and 4 attention calls)."""
    gn, attn = p2_call_shapes()
    assert dict(gn) == P2_GN_SHAPES and sum(gn.values()) == 65
    assert dict(attn) == P2_ATTN_SHAPES and sum(attn.values()) == 4


def _tensor_core_attention_model(q, k, v, block=64, scale=None):
    """Plain-torch model of csrc/flash_attention.cu's bf16 route: q * d^-1/4
    and k * d^-1/4 rounded to bf16, f32 logits and online softmax over
    `block`-key tiles, unnormalized P rounded to bf16 before P V with f32
    accumulation, one f32 division by the row sum, output rounded to bf16.
    k and v may hold another number of keys than q has queries (the last
    key tile is then ragged: its missing keys add nothing); v may be a
    column slice of the values (the wide-head route). `scale` defaults to
    that of q's head dim (a caller that pads or cuts the dims passes it)."""
    scale = _scale(q.shape[-1]) if scale is None else scale
    qs, ks = (q * scale).float(), (k * scale).float()
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + v.shape[-1:], dtype=torch.float32)
    for j0 in range(0, k.shape[-2], block):
        s = qs @ ks[..., j0:j0 + block, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ v[..., j0:j0 + block, :].float()
        m = m_new
    return (acc / l).bfloat16()


def _bf16_attn_tol(ref, cap=3e-2):
    """The bf16 attention tolerance of chip_smoke.py and the card's tests:
    two ulps of the largest |ref| (2^-6 of it), at most cap."""
    return min(cap, 2 ** -6 * ref.float().abs().max().item())


@pytest.mark.parametrize("sigma", [1.0, 2.0])
@pytest.mark.parametrize("shape", [(2, 8, 256, 64), (2, 8, 64, 64), (1, 3, 129, 16),
                                   (1, 2, 65, 128), (1, 2, 1, 32)])
def test_tensor_core_attention_rounding_within_bf16_tolerance(shape, sigma):
    """The bf16 kernel rounds at other places than attention_plain (P before
    normalizing, not the normalized weights); at P2 shapes and magnitudes the
    model of its rounding stays within the bf16 tolerance that
    chip_smoke.py and the card's tests hold the kernel to."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(20, shape))
    q, k = (q * sigma).bfloat16(), (k * sigma).bfloat16()
    got = _tensor_core_attention_model(q, k, v)
    ref = attention_plain(q, k, v)
    assert (got.float() - ref.float()).abs().max().item() <= _bf16_attn_tol(ref)


def _wide_head_attention_model(q, k, v):
    """The bf16 route at D > 128: one block per 128-column output slice,
    each forming the full logits over all D (bf16 q and k chunks, f32
    sums) with the online softmax over 32-key tiles, and accumulating only
    its slice of P V."""
    return torch.cat([_tensor_core_attention_model(q, k, v[..., c:c + SLICE], block=32)
                      for c in range(0, q.shape[-1], SLICE)], dim=-1)


@pytest.mark.parametrize("sigma", [1.0, 2.0])
@pytest.mark.parametrize("n", [64, 256, 65])
@pytest.mark.parametrize("d", [256, 512])
def test_wide_head_attention_rounding_within_bf16_tolerance(d, n, sigma):
    """The wide-head route's rounding and column split at the DDPM U-Net's
    single-head shapes (D = C = 512 at N = 256 and 64) and a ragged N stays
    within the bf16 tolerance the card's checks hold the kernel to."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(22, (2, 1, n, d)))
    q, k = (q * sigma).bfloat16(), (k * sigma).bfloat16()
    got = _wide_head_attention_model(q, k, v)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    ref = attention_plain(q, k, v)
    assert (got.float() - ref.float()).abs().max().item() <= _bf16_attn_tol(ref)


@pytest.mark.parametrize("sigma", [2.0, 1e-3])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 4, 4, 512)])
def test_group_norm_eps_1e6_matches_jax(shape, sigma):
    """The DDPM U-Net's GroupNorm, eps 1e-6, against the JAX package's
    group_norm_f32 at the same eps, f32 (atol 1e-5 on O(1) outputs). At
    sigma 1e-3 the group variance is ~1e-6, so eps 1e-5 would give a
    visibly other result: the test tells the two apart."""
    x, s, b = _gn_inputs(23, shape)
    x = (x - 0.5) * (sigma / 2)
    ref = np.asarray(jax_gn(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=1e-6))
    got = nhwc(group_norm_f32(nchw(x), torch.from_numpy(s), torch.from_numpy(b), eps=1e-6))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    if sigma < 1e-2:
        other = nhwc(group_norm_plain(nchw(x), torch.from_numpy(s), torch.from_numpy(b),
                                      eps=1e-5))
        assert np.abs(other - ref).max() > 0.1


@pytest.mark.parametrize("chw", sorted(P2_GN_SHAPES))
def test_groupnorm_launch_geometry_at_p2_shapes(chw):
    """csrc/groupnorm.cu's geometry at each P2 (C, H, W), batch 1 and 45, bf16
    and f32: 16-byte vectors across C, about 256 threads a block, chunks of
    whole unrolled steps that cover every pixel once, more than half of 2112
    blocks (16 per SM of 132) where the tensor has that many steps of 32 KB
    or more, shared memory under 48 KB, and the scratch the kernel indexes."""
    c, h, w = chw
    hw = h * w
    for b in (1, 45):
        for itemsize in (2, 4):
            geo = launch_geometry(b, c, hw, itemsize)
            assert geo.vec * itemsize == 16 and geo.threads_x * geo.vec == c
            assert geo.threads_x * geo.rows <= 256
            step = geo.rows * 4
            assert geo.chunk % step == 0
            assert (geo.chunks - 1) * geo.chunk < hw <= geo.chunks * geo.chunk
            want = min(2112, b * -(-hw // step), b * max(1, hw * c * itemsize // 32768))
            assert 2 * b * geo.chunks > want
            assert 2 * max(geo.rows * c, 32 * 8) * 4 <= 48 * 1024
            assert geo.work == 2 * b * geo.chunks * 32 + 2 * b * 32


def _two_launch_model(x, scale, bias, geo, groups=32, eps=1e-5):
    """numpy f32 model of the kernel's reduction: per-chunk group partials,
    then the last block's sums over chunk subsets k, k + 8, ... in order."""
    b, hw, c = x.shape
    cg = c // groups
    part = np.zeros((2, b, geo.chunks, groups), np.float32)
    for i in range(geo.chunks):
        blk = x[:, i * geo.chunk:(i + 1) * geo.chunk]
        for j, v in enumerate((blk, blk * blk)):
            part[j, :, i] = v.sum(1).reshape(b, groups, cg).sum(-1)
    s, ss = (np.sum([p[:, k::8].sum(1) for k in range(8)], axis=0) for p in part)
    n = np.float32(hw * cg)
    mean = s / n
    rstd = 1 / np.sqrt(np.maximum(ss / n - mean * mean, 0) + np.float32(eps))
    rep = lambda t: np.repeat(t, cg, axis=1)[:, None, :]          # noqa: E731
    return (x - rep(mean)) * rep(rstd) * scale + bias


@pytest.mark.parametrize("shape", [(2, 5, 7, 64), (1, 9, 9, 384), (3, 16, 16, 96),
                                   (45, 8, 8, 1024), (2, 8, 8, 2560), (1, 16, 16, 1920)])
def test_groupnorm_two_launch_model_matches_plain(shape):
    """The kernel's chunked, fixed-order reduction over its launch geometry
    gives group_norm_plain's result (f32, atol 1e-5)."""
    x, s, b = _gn_inputs(21, shape)
    bsz, h, w, c = shape
    geo = launch_geometry(bsz, c, h * w, 4)
    got = _two_launch_model(x.reshape(bsz, h * w, c), s, b, geo)
    ref = nhwc(group_norm_plain(nchw(x), torch.from_numpy(s), torch.from_numpy(b)))
    np.testing.assert_allclose(got.reshape(shape), ref, atol=1e-5)


# -- the Stable Diffusion shapes: cross-attention and wide GroupNorm rows -------

@pytest.mark.parametrize("sigma", [1.0, 2.0])
@pytest.mark.parametrize("heads,nq,nkv", sorted({(h, nq, nkv) for h, nq, nkv, _ in
                                                 SD_UNET_ATTN_SHAPES if nkv == 77})
                         + [(1, 65, 7), (2, 7, 130)])
def test_cross_attention_tail_tile_rounding_within_bf16_tolerance(heads, nq, nkv, sigma):
    """The bf16 route at the SD U-Net's cross-attention (N_kv = 77 = 64 +
    13: one whole and one ragged key tile) and ragged small cases: the
    model of its rounding stays within the tolerance the card holds the
    kernel to at these shapes, two bf16 ulps of the largest output
    (outputs reach |y| > 4 at sigma 2, where one ulp is 2^-5); at sigma 1,
    keys past N_kv counted as zero logits instead of masked to -inf would
    be outside it."""
    g = np.random.default_rng(24)
    q = torch.from_numpy(g.normal(size=(2, heads, nq, 64)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(g.normal(size=(2, heads, nkv, 64)).astype(np.float32))
            .bfloat16() for _ in range(2))
    q, k = (q * sigma).bfloat16(), (k * sigma).bfloat16()
    ref = attention_plain(q, k, v)
    got = _tensor_core_attention_model(q, k, v)
    assert got.shape == q.shape
    tol = _bf16_attn_tol(ref, cap=float("inf"))
    assert (got.float() - ref.float()).abs().max().item() <= tol
    pad = -nkv % 64
    if pad and sigma == 1.0:       # at sigma 2 the softmax is too peaked to see them
        kp, vp = (torch.cat([t, torch.zeros(*t.shape[:2], pad, 64, dtype=t.dtype)], 2)
                  for t in (k, v))
        unmasked = _tensor_core_attention_model(q, kp, vp)
        assert (unmasked.float() - ref.float()).abs().max().item() > tol


@pytest.mark.parametrize("chw", sorted({k[:3] for k in (*SD_UNET_GN_SHAPES, *SD_DEC_GN_SHAPES,
                                                          *SD_ENC_GN_SHAPES)}))
def test_groupnorm_launch_geometry_at_sd_shapes(chw):
    """csrc/groupnorm.cu's geometry at each SD (C, H, W), batch 1 and 2
    (CFG), bf16 and f32: 16-byte vectors across C, one vector a thread up
    to 512 vectors a pixel and two above (f32 at C = 2560: 320 threads),
    every channel covered once, chunks covering every pixel once, shared
    memory under 48 KB."""
    c, h, w = chw
    hw = h * w
    for b in (1, 2):
        for itemsize in (2, 4):
            geo = launch_geometry(b, c, hw, itemsize)
            assert geo.vec * itemsize == 16
            assert geo.nvec == (1 if c // geo.vec <= 512 else 2)
            assert geo.threads_x * geo.vec * geo.nvec == c and geo.threads_x <= 512
            assert geo.chunk % (geo.rows * 4) == 0
            assert (geo.chunks - 1) * geo.chunk < hw <= geo.chunks * geo.chunk
            assert 2 * max(geo.rows * c, 32 * 8) * 4 <= 48 * 1024
    assert launch_geometry(1, 2560, 64, 4).nvec == 2
    assert launch_geometry(1, 1920, 256, 4).nvec == 1


# -- head dims 40, 80, 160 (the SD 1.5 / LCM U-Net: 8 heads of 320, 640, 1280) --

def _naive_geometry(d):
    """The tiling the kernel had before it took these dims: D / 16 k-steps
    and D / min(D, 128) slices of min(D, 128) columns."""
    dv = min(d, SLICE)
    return AttnGeometry(d // dv, dv, d // 16 * 16, 32 if d > SLICE else 64)


def _tiled_attention_model(q, k, v, geo):
    """The bf16 route under a tiling: Q K^T over geo.kd dims (q and k
    zero-padded past D, or cut short of it), one block of the
    tensor-core model per output slice of geo.dv columns; columns no
    slice covers stay 0."""
    d = q.shape[-1]
    if geo.kd >= d:
        pad = lambda t: torch.cat([t, t.new_zeros(*t.shape[:-1], geo.kd - d)], -1)  # noqa: E731
        qk = pad(q), pad(k)
    else:
        qk = q[..., :geo.kd], k[..., :geo.kd]
    out = torch.zeros(q.shape, dtype=torch.bfloat16)
    for c in range(0, geo.slices * geo.dv, geo.dv):
        out[..., c:c + geo.dv] = _tensor_core_attention_model(
            *qk, v[..., c:c + geo.dv], block=geo.block_k, scale=_scale(d))
    return out


@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 128, 160, 256, 512])
def test_attention_kernel_geometry_covers_every_head_dim(d):
    """csrc/flash_attention.cu's Geo<D> (mirrored by kernel_geometry): equal
    slices of whole 8-wide n-tiles covering D exactly, at most 128 columns;
    k-steps covering D with at most one zero 16-byte chunk of padding; row
    strides of an odd number of 16-byte chunks (the 8 rows an ldmatrix reads
    in distinct banks); shared memory under the 227 KB opt-in limit."""
    geo = kernel_geometry(d)
    assert geo.slices * geo.dv == d and geo.dv % 8 == 0 and geo.dv <= SLICE
    assert geo.kd % 16 == 0 and 0 <= geo.kd - d <= 8
    r16 = lambda x: -(-x // 16) * 16  # noqa: E731
    q_stride, v_stride = geo.kd + 8, r16(geo.dv) + 8
    assert (q_stride * 2 // 16) % 2 == 1 and (v_stride * 2 // 16) % 2 == 1
    smem = (64 * q_stride + 2 * geo.block_k * q_stride + 2 * geo.block_k * v_stride) * 2
    assert smem <= 232448
    expected = {40: (1, 40, 48, 64), 80: (1, 80, 80, 64), 160: (2, 80, 160, 32),
                256: (2, 128, 256, 32), 512: (4, 128, 512, 32)}
    assert tuple(geo) == expected.get(d, (1, d, d, 64))


@pytest.mark.parametrize("sigma", [1.0, 2.0])
@pytest.mark.parametrize("nkv", [None, 77])
@pytest.mark.parametrize("d,nq", [(40, 256), (80, 130), (160, 96)])
def test_head_dims_40_80_160_rounding_and_geometry(d, nq, nkv, sigma):
    """At the LCM U-Net's head dims, self- (N_kv = N_q) and cross-attention
    (N_kv = 77): the kernel's tiling (D = 40: a zero-padded third k-step of
    48; D = 160: two slices of 80 columns) stays within the bf16 tolerance
    the card holds the kernel to; the naive tiling (D / 16 k-steps: 8 of 40
    dims dropped from the logits; D / 128 slices of 128: 32 of 160 output
    columns never written) misses it."""
    g = np.random.default_rng(25 + d)
    nkv = nq if nkv is None else nkv
    q = torch.from_numpy(g.normal(size=(2, 2, nq, d)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(g.normal(size=(2, 2, nkv, d)).astype(np.float32)).bfloat16()
            for _ in range(2))
    q, k = (q * sigma).bfloat16(), (k * sigma).bfloat16()
    ref = attention_plain(q, k, v)
    tol = _bf16_attn_tol(ref, cap=float("inf"))
    got = _tiled_attention_model(q, k, v, kernel_geometry(d))
    assert (got.float() - ref.float()).abs().max().item() <= tol
    naive = _naive_geometry(d)
    if naive != kernel_geometry(d):
        off = _tiled_attention_model(q, k, v, naive)
        assert (off.float() - ref.float()).abs().max().item() > tol


@pytest.mark.parametrize("width,d", [(320, 40), (640, 80), (1280, 160)])
def test_lcm_head_split_views_meet_the_bf16_copy_rules(width, d):
    """The SD 1.5 / LCM head split, (B, N, 8 * D) -> (B, 8, N, D) views,
    meets the bf16 route's 16-byte cp.async rules as it is (head dim of
    stride 1, strides multiples of 8 elements, 16-byte aligned heads), so
    AttentionFn hands it to the kernel without a copy."""
    x = torch.zeros(2, 77, width, dtype=torch.bfloat16)
    heads = x.reshape(2, 77, 8, d).transpose(1, 2)
    assert _kernel_layout(heads)
    for h in range(8):
        assert heads[:, h].data_ptr() % 16 == 0

"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test decides inside itself whether a card is present and
skips with a reason otherwise. Run on a machine with an NVIDIA GPU:
`python -m pytest -m cuda tests/test_torch_cuda.py`.
"""

import pytest
import torch

from loco_edit_tpu_torch.ops.flash_attention import (HEAD_DIMS, AttentionFn, attention_plain,
                                                     flash_attention_cuda, kernel_geometry)
from loco_edit_tpu_torch.ops.groupnorm import (GroupNormFn, group_norm_apply_cuda,
                                               group_norm_apply_plain, group_norm_cuda,
                                               group_norm_plain, group_norm_sums_cuda,
                                               group_norm_sums_plain)
from _torch_ddpm_shapes import DDPM_ATTN_SHAPES, DDPM_GN_EPS, DDPM_GN_SHAPES
from _torch_if_shapes import (IF_CONTEXT, IF_I_M_ATTN_SHAPES, IF_I_M_GN_SHAPES,
                              LCM_ATTN_SHAPES, LCM_CONTEXT)
from _torch_p2_shapes import P2_GN_SHAPES
from _torch_sd_shapes import (SD_CONTEXT, SD_DEC_GN_SHAPES, SD_ENC_GN_SHAPES,
                              SD_UNET_ATTN_SHAPES, SD_UNET_GN_SHAPES,
                              SD_VAE_ATTN_SHAPES)

pytestmark = pytest.mark.cuda

# Tolerances: f32 differs from the plain version only by summation order
# (atol 1e-4 on O(1) outputs); bf16 outputs are one bf16 rounding of nearby
# f32 values, within two bf16 ulps at |y| <= 8 (atol 6e-2).
ATOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}


def attn_tol(ref: torch.Tensor, dtype, cap: float = ATOL[torch.bfloat16] / 2) -> float:
    """Attention against its plain version: f32 5e-5; bf16 two ulps of the
    largest |ref| (2^-6 of it: the kernel rounds P before normalizing, the
    plain version after, within one ulp), at most cap. Outputs shrink with
    the keys averaged (max |y| ~ 0.15 at 4096 keys), so no absolute floor."""
    if dtype == torch.float32:
        return ATOL[torch.float32] / 2
    return min(cap, 2 ** -6 * ref.float().abs().max().item())


def attn_mutant_errs(q, k, v, tile: int | None = None, scale: float = 1.03) -> list[float]:
    """How far a kernel that skipped the last key tile (of `tile` keys, by
    default the route's: kernel_geometry(D, dtype).block_k), or scaled the
    logits by `scale`, would land from the plain version (f32, the same
    inputs)."""
    tile = tile or kernel_geometry(q.shape[-1], q.dtype).block_k
    q, k, v = q.float(), k.float(), v.float()
    ref = attention_plain(q, k, v)
    keep = k.shape[2] - ((k.shape[2] - 1) % tile + 1)
    return [(attention_plain(q * scale, k, v) - ref).abs().max().item(),
            (attention_plain(q, k[:, :, :keep], v[:, :, :keep]) - ref).abs().max().item()]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 128, 256, 256), (2, 96, 8, 8),
                                   (3, 384, 17, 9), (45, 1024, 8, 8)])
def test_groupnorm_kernel_matches_plain(shape, dtype):
    g = _card()
    b, c, h, w = shape
    x = (torch.randn(b, h, w, c, device="cuda", generator=g) * 2 + 0.3).to(dtype)
    x = x.permute(0, 3, 1, 2)
    s = torch.randn(c, device="cuda", generator=g)
    bias = torch.randn(c, device="cuda", generator=g)
    before = group_norm_cuda.launches
    got = group_norm_cuda(x, s, bias)
    torch.cuda.synchronize()
    assert group_norm_cuda.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    ref = group_norm_plain(x, s, bias)
    assert (got.float() - ref.float()).abs().max().item() <= ATOL[dtype]


def _gn_inputs(g, shape, dtype):
    b, c, h, w = shape
    x = (torch.randn(b, h, w, c, device="cuda", generator=g) * 2 + 0.3).to(dtype)
    return (x.permute(0, 3, 1, 2), torch.randn(c, device="cuda", generator=g),
            torch.randn(c, device="cuda", generator=g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chw", sorted(P2_GN_SHAPES))
def test_groupnorm_kernel_at_every_p2_shape(chw, dtype):
    """Batch 2 at each (C, H, W) a P2 forward gives the kernel."""
    x, s, bias = _gn_inputs(_card(), (2, *chw), dtype)
    got = group_norm_cuda(x, s, bias)
    torch.cuda.synchronize()
    assert (got.float() - group_norm_plain(x, s, bias).float()).abs().max().item() \
        <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chw", sorted(DDPM_GN_SHAPES))
def test_groupnorm_kernel_at_every_ddpm_shape_eps_1e6(chw, dtype):
    """Batch 2 at each (C, H, W) a CelebA_HQ_HF forward gives the kernel, at
    the DDPM U-Net's eps 1e-6, with small-variance inputs where eps shows."""
    x, s, bias = _gn_inputs(_card(), (2, *chw), dtype)
    x = (x * 1e-3).to(dtype)
    got = group_norm_cuda(x, s, bias, eps=DDPM_GN_EPS)
    torch.cuda.synchronize()
    ref = group_norm_plain(x, s, bias, eps=DDPM_GN_EPS)
    assert (got.float() - ref.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chw", sorted(P2_GN_SHAPES))
def test_groupnorm_split_entries_at_every_p2_shape(chw, dtype):
    """The statistics entry against its plain version (1e-5 of the largest
    sum: f32 summation order), the normalize entry from sums over twice the
    rows (as two ranks' all-reduced sums) against its plain version, and
    sums -> apply over x's own rows: the fused entry's bits."""
    x, s, bias = _gn_inputs(_card(), (1, *chw), dtype)
    c, h, w = chw
    b0 = (group_norm_sums_cuda.launches, group_norm_apply_cuda.launches)
    sums = group_norm_sums_cuda(x)
    ref = group_norm_sums_plain(x)
    assert (sums - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    n = h * w * c // 32
    assert torch.equal(group_norm_apply_cuda(x, sums, n, s, bias), group_norm_cuda(x, s, bias))
    got = group_norm_apply_cuda(x, 2 * sums, 2 * n, s, bias)
    want = group_norm_apply_plain(x, 2 * sums, 2 * n, s, bias)
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]
    assert (group_norm_sums_cuda.launches, group_norm_apply_cuda.launches) == \
        (b0[0] + 1, b0[1] + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_kernel_same_bits_every_run(dtype):
    """Two launches on one input give identical bits, also with launches of
    other batch sizes between them (the tickets are back at 0 after each)."""
    g = _card()
    x, s, bias = _gn_inputs(g, (45, 128, 64, 64), dtype)
    other = _gn_inputs(g, (3, 512, 16, 16), dtype)
    first = group_norm_cuda(x, s, bias)
    group_norm_cuda(*other)
    second = group_norm_cuda(x, s, bias)
    assert torch.equal(first, second)
    assert torch.equal(group_norm_cuda(*other), group_norm_cuda(*other))


def test_groupnorm_rejects_misaligned_input():
    _card()
    flat = torch.zeros(1 + 4 * 4 * 32, device="cuda", dtype=torch.bfloat16)
    x = flat[1:].view(1, 4, 4, 32).permute(0, 3, 1, 2)
    one, zero = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        group_norm_cuda(x, one, zero)
    got = GroupNormFn.apply(x, one, zero, 32, 1e-5)   # the Function copies it
    assert torch.equal(got, group_norm_plain(x.cpu(), one.cpu(), zero.cpu()).cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(
    {(1, 8, 256, 64), (1, 8, 64, 64), (45, 8, 256, 64), (2, 3, 100, 16), (1, 2, 77, 128),
     (1, 2, 65, 32)}
    | {(2, 2, 77, d) for d in HEAD_DIMS} | {(1, 2, 1101, d) for d in HEAD_DIMS}))
def test_attention_kernel_matches_plain(shape, dtype):
    """Both routes at the P2 shapes and at every head dim with N = 77 and
    1101 (ragged last key and query tiles on every route's tiling)."""
    g = _card()
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(3))
    got = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v)
    assert (got.float() - ref.float()).abs().max().item() <= attn_tol(ref, dtype)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 63, 65, 129, 257])
def test_attention_bf16_ragged_tiles(n, d):
    """The tensor-core route at N that leave ragged query and key tiles."""
    g = _card()
    q, k, v = (torch.randn(2, 3, n, d, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    got = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v)
    assert (got.float() - ref.float()).abs().max().item() <= attn_tol(ref, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("n", [1, 63, 64, 65, 256, 257])
@pytest.mark.parametrize("aligned", [True, False])
def test_attention_wide_heads_on_strided_views(aligned, n, d, dtype):
    """Every head dim (the wide-head routes: bf16 D / 128 output-column
    slices, f32 warps that split the columns) at ragged N, on head-split
    views of one packed qkv tensor, 16-byte aligned or one element off.
    The f32 route takes either view as it is (4-byte copies for the second);
    AttentionFn hands the bf16 route a copy of a misaligned one. Against
    the plain version (attn_tol); one launch per call."""
    g = _card()
    off = 0 if aligned else 1
    flat = torch.randn(off + 2 * n * 6 * d, device="cuda", generator=g).to(dtype)
    qkv = flat[off:].view(2, n, 6 * d)
    q, k, v = (t.reshape(2, n, 2, d).transpose(1, 2) for t in qkv.split(2 * d, -1))
    before, copies = flash_attention_cuda.launches, AttentionFn.layout_copies
    got = AttentionFn.apply(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    copied = 0 if aligned or dtype == torch.float32 else 3
    assert AttentionFn.layout_copies - copies == copied
    ref = attention_plain(q, k, v)
    assert (got.float() - ref.float()).abs().max().item() <= attn_tol(ref, dtype)


def test_attention_kernel_takes_strided_heads():
    g = _card()
    qkv = torch.randn(2, 256, 3 * 512, device="cuda", generator=g)
    q, k, v = (t.reshape(2, 256, 8, 64).transpose(1, 2) for t in qkv.split(512, -1))
    got = flash_attention_cuda(q, k, v)
    assert (got - attention_plain(q, k, v)).abs().max().item() <= 1e-5


def test_attention_bf16_takes_strided_heads():
    """The head-split bf16 views the model passes, taken without a copy."""
    g = _card()
    qkv = torch.randn(2, 256, 3 * 512, device="cuda", generator=g).bfloat16()
    q, k, v = (t.reshape(2, 256, 8, 64).transpose(1, 2) for t in qkv.split(512, -1))
    got = flash_attention_cuda(q, k, v)
    ref = attention_plain(q, k, v)
    assert (got.float() - ref.float()).abs().max().item() <= attn_tol(ref, torch.bfloat16)


def test_attention_bf16_rejects_misaligned_views():
    g = _card()
    flat = torch.randn(1 + 2 * 64 * 32, device="cuda", generator=g).bfloat16()
    q = flat[1:].view(1, 2, 64, 32)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, q, q)
    got = AttentionFn.apply(q, q, q)                  # the Function copies it
    ref = attention_plain(q, q, q)
    assert (got.float() - ref.float()).abs().max().item() <= attn_tol(ref, torch.bfloat16)


def test_wrappers_reject_what_the_kernels_do_not_take():
    _card()
    q = torch.zeros(1, 1, 8, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q)
    h = q.half()[..., :32]
    with pytest.raises(TypeError):
        flash_attention_cuda(h, h, h)
    x = torch.zeros(1, 48, 4, 4, device="cuda").contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="divide"):
        group_norm_cuda(x, torch.ones(48, device="cuda"), torch.zeros(48, device="cuda"))
    with pytest.raises(ValueError, match="channels_last"):
        group_norm_cuda(torch.zeros(1, 32, 4, 4, device="cuda"),
                        torch.ones(32, device="cuda"), torch.zeros(32, device="cuda"))


def test_functions_jvp_vjp_on_card_match_cpu():
    """The Functions' rules on CUDA tensors (kernel forward, plain rules)
    equal the same rules on the CPU (plain forward), f32."""
    g = _card()
    x = torch.randn(2, 4, 4, 64, device="cuda", generator=g).permute(0, 3, 1, 2)
    s, b = (torch.randn(64, device="cuda", generator=g) for _ in range(2))
    tan = torch.randn(3, *x.shape, device="cuda", generator=g)
    outs = []
    for dev in ("cuda", "cpu"):
        xd, sd, bd, td = (t.to(dev) for t in (x, s, b, tan))
        f = lambda z: AttentionFn.apply(*(GroupNormFn.apply(z, sd, bd, 32, 1e-5)  # noqa: E731
                                          .reshape(2, 4, 16, 16),) * 3)
        jv = torch.func.vmap(lambda t: torch.func.jvp(f, (xd,), (t,))[1])(td)
        _, pull = torch.func.vjp(f, xd)
        vj = torch.func.vmap(lambda u: pull(u)[0])(jv)
        outs.append((jv.cpu(), vj.cpu()))
    for a, c in zip(*outs):
        assert (a - c).abs().max().item() <= 1e-4


def test_tiny_adm_on_card_matches_cpu():
    _card()
    from loco_edit_tpu_torch.models.registry import load_tiny_denoiser

    gpu = load_tiny_denoiser(device="cuda")
    cpu = load_tiny_denoiser(device="cpu")
    cpu.meta["model"].load_state_dict(gpu.meta["model"].state_dict())
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    got = gpu.eps_fn(x.cuda(), 321.0).cpu()
    ref = cpu.eps_fn(x, 321.0)
    assert (got - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


def test_celeba_hq_hf_bf16_forward_launches_71_gn_and_6_attention():
    """One full-width CelebA_HQ_HF forward in bf16 on the card: finite eps
    of the input's shape, and the launch counters read exactly 71 GroupNorm
    and 6 attention launches (every call went through a kernel, once)."""
    _card()
    from loco_edit_tpu_torch.models.ddpm import load_ddpm_denoiser

    den = load_ddpm_denoiser("CelebA_HQ_HF", dtype=torch.bfloat16, device="cuda")
    x = torch.randn(2, 256, 256, 3, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    gn0, at0 = group_norm_cuda.launches, flash_attention_cuda.launches
    with torch.no_grad():
        eps = den.eps_fn(x, 500.0)
    torch.cuda.synchronize()
    assert eps.shape == x.shape and eps.dtype == torch.float32
    assert torch.isfinite(eps).all()
    assert group_norm_cuda.launches - gn0 == sum(DDPM_GN_SHAPES.values()) == 71
    assert flash_attention_cuda.launches - at0 == sum(DDPM_ATTN_SHAPES.values()) == 6


# -- the Stable Diffusion 2.1-base shapes ---------------------------------------

@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chw", [(320, 64, 64), (640, 32, 32), (960, 32, 32),
                                 (1920, 16, 16), (2560, 8, 8), (2560, 16, 16)])
def test_groupnorm_kernel_at_sd_widths(chw, dtype, eps, batch):
    """The SD U-Net's channel counts, the skip concatenations' 1920 and 2560
    included (f32 there takes two 16-byte vectors a thread), at both of its
    eps, with small-variance inputs where eps shows."""
    x, s, bias = _gn_inputs(_card(), (batch, *chw), dtype)
    x = (x * 1e-3).to(dtype)
    got = group_norm_cuda(x, s, bias, eps=eps)
    torch.cuda.synchronize()
    ref = group_norm_plain(x, s, bias, eps=eps)
    assert (got.float() - ref.float()).abs().max().item() <= ATOL[dtype]
    assert torch.equal(got, group_norm_cuda(x, s, bias, eps=eps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted({k[:3] for k in (*SD_UNET_GN_SHAPES,
                                                            *SD_DEC_GN_SHAPES,
                                                            *SD_ENC_GN_SHAPES)}))
def test_groupnorm_kernel_at_every_sd_shape(shape, dtype):
    """Batch 2 (the CFG batch) at each (C, H, W) of one SD U-Net forward,
    VAE decode and VAE encode."""
    x, s, bias = _gn_inputs(_card(), (2, *shape), dtype)
    got = group_norm_cuda(x, s, bias, eps=1e-6)
    torch.cuda.synchronize()
    ref = group_norm_plain(x, s, bias, eps=1e-6)
    assert (got.float() - ref.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 512])
@pytest.mark.parametrize("nq,nkv", [(4096, 77), (1024, 77), (64, 77), (256, 7),
                                    (7, 256), (77, 4096), (100, 4096), (65, 1)])
def test_attention_cross_lengths(nq, nkv, d, dtype):
    """N_q != N_kv both ways on both routes, N_kv of 7, 77 and 4096 (ragged
    last key tiles of 7, 13 and none), against the plain version (f32 5e-5;
    bf16 two ulps of the largest output, however small); one launch per
    call. Where there are two key tiles or more, a kernel that skipped the
    last one or scaled the logits by 1.03 would miss that tolerance."""
    g = _card()
    heads = 2 if d == 64 else 1
    q = torch.randn(2, heads, nq, d, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(2, heads, nkv, d, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1 and got.shape == q.shape
    ref = attention_plain(q, k, v).float()
    tol = attn_tol(ref, dtype, cap=float("inf"))
    assert (got.float() - ref).abs().max().item() <= tol
    if nkv > kernel_geometry(d, dtype).block_k:
        assert min(attn_mutant_errs(q, k, v)) > tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_cross_on_head_split_views(dtype):
    """The SD cross-attention's views: q head-split from (B, 4096, 320) and
    k, v from one packed (B, 77, 640) projection, taken without a copy."""
    g = _card()
    x = torch.randn(2, 4096, 320, device="cuda", generator=g).to(dtype)
    kv = torch.randn(2, 77, 640, device="cuda", generator=g).to(dtype)
    q = x.reshape(2, 4096, 5, 64).transpose(1, 2)
    k, v = (t.reshape(2, 77, 5, 64).transpose(1, 2) for t in kv.split(320, -1))
    copies = AttentionFn.layout_copies
    got = AttentionFn.apply(q, k, v)
    torch.cuda.synchronize()
    assert AttentionFn.layout_copies == copies
    ref = attention_plain(q, k, v).float()
    tol = attn_tol(ref, dtype, cap=float("inf"))
    assert (got.float() - ref).abs().max().item() <= tol
    assert min(attn_mutant_errs(q, k, v)) > tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("d,nq", [(40, 4096), (40, 100), (80, 1024), (80, 65),
                                  (160, 256), (160, 64), (160, 33), (16, 100), (32, 65),
                                  (64, 257), (128, 130), (256, 100), (512, 100)])
def test_attention_head_dims_40_80_160(d, nq, cross, dtype):
    """The SD 1.5 / LCM U-Net's head dims (8 heads of 320, 640, 1280), and
    every other head dim, on both routes, N_kv = N_q and N_kv = 77, on
    head-split views of packed projections as the U-Net makes them: within
    the plain version's tolerance, every output column written (bf16 D =
    160: two slices of 80), and a kernel that skipped the last key tile or
    scaled the logits by 1.03 would miss it."""
    g = _card()
    nkv = 77 if cross else nq
    x = torch.randn(2, nq, 8 * d, device="cuda", generator=g).to(dtype)
    kv = torch.randn(2, nkv, 16 * d, device="cuda", generator=g).to(dtype)
    q = x.reshape(2, nq, 8, d).transpose(1, 2)
    k, v = (t.reshape(2, nkv, 8, d).transpose(1, 2) for t in kv.split(8 * d, -1))
    copies = AttentionFn.layout_copies
    got = AttentionFn.apply(q, k, v)
    torch.cuda.synchronize()
    assert AttentionFn.layout_copies == copies and got.shape == q.shape
    ref = attention_plain(q, k, v).float()
    tol = attn_tol(ref, dtype, cap=float("inf"))
    assert torch.isfinite(got).all()
    assert (got.float() - ref).abs().max().item() <= tol
    if nkv > kernel_geometry(d, dtype).block_k:
        assert min(attn_mutant_errs(q, k, v)) > tol


@pytest.mark.parametrize("which", ["unet", "decoder", "encoder"])
def test_sd_bf16_forward_launch_counts(which):
    """One full-width SD 2.1-base forward in bf16 on the card: finite output
    of the expected shape, and the launch counters read exactly the calls
    of tests/_torch_sd_shapes.py (61 GN + 32 attention per U-Net forward,
    30 + 1 per decode, 22 + 1 per encode)."""
    _card()
    from loco_edit_tpu_torch.models.sd import (SDUNet, VAEConfig, VAEDecoder,
                                               VAEEncoder, sd_preset)

    gen = torch.Generator("cuda").manual_seed(1)
    with torch.device("cuda"):
        if which == "unet":
            m = SDUNet(sd_preset("sd21-base", dtype=torch.bfloat16))
            args = (torch.randn(2, 64, 64, 4, device="cuda", generator=gen), 500.0,
                    0.2 * torch.randn(2, *SD_CONTEXT, device="cuda", generator=gen))
            shapes, want = (SD_UNET_GN_SHAPES, SD_UNET_ATTN_SHAPES), (2, 64, 64, 4)
        elif which == "decoder":
            m = VAEDecoder(VAEConfig(dtype=torch.bfloat16))
            args = (torch.randn(1, 64, 64, 4, device="cuda", generator=gen),)
            shapes, want = (SD_DEC_GN_SHAPES, SD_VAE_ATTN_SHAPES), (1, 512, 512, 3)
        else:
            m = VAEEncoder(VAEConfig(dtype=torch.bfloat16))
            args = (torch.rand(1, 512, 512, 3, device="cuda", generator=gen) * 2 - 1,)
            shapes, want = (SD_ENC_GN_SHAPES, SD_VAE_ATTN_SHAPES), (1, 64, 64, 4)
    m.init_random_(gen).requires_grad_(False)
    gn0, at0 = group_norm_cuda.launches, flash_attention_cuda.launches
    with torch.no_grad():
        out = m(*args)
    out = out[0] if isinstance(out, tuple) else out
    torch.cuda.synchronize()
    assert out.shape == want and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert group_norm_cuda.launches - gn0 == sum(shapes[0].values())
    assert flash_attention_cuda.launches - at0 == sum(shapes[1].values())


# -- DeepFloyd IF-I-M and LCM Dreamshaper v7 ---------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(IF_I_M_GN_SHAPES))
def test_groupnorm_kernel_at_every_if_shape(shape, dtype):
    """GN at every IF-I-M (C, H, W) at the CFG batch 2, the norm_cross over
    the 77 text states (C x 1 x 77) included; the same bits on two
    launches."""
    x, s, bias = _gn_inputs(_card(), (2, *shape[:3]), dtype)
    got = group_norm_cuda(x, s, bias, eps=shape[3])
    torch.cuda.synchronize()
    ref = group_norm_plain(x, s, bias, eps=shape[3])
    assert (got.float() - ref.float()).abs().max().item() <= ATOL[dtype]
    assert torch.equal(got, group_norm_cuda(x, s, bias, eps=shape[3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(IF_I_M_ATTN_SHAPES))
def test_attention_at_every_if_shape(shape, dtype):
    """IF-I-M's added-KV attention at the CFG batch 2 (N_kv = 77 text keys
    + N_q image keys, ragged last key tiles of 13) on head-split views of
    the concatenated keys, as IFAttention makes them."""
    g = _card()
    heads, nq, nkv, d = shape
    c = heads * d
    x = torch.randn(2, nq, 3 * c, device="cuda", generator=g).to(dtype)
    text = torch.randn(2, nkv - nq, 2 * c, device="cuda", generator=g).to(dtype)
    q, k, v = x.split(c, -1)
    k = torch.cat([text[..., :c], k], 1)
    v = torch.cat([text[..., c:], v], 1)
    split = lambda t: t.reshape(2, t.shape[1], heads, d).transpose(1, 2)  # noqa: E731
    q, k, v = split(q), split(k), split(v)
    copies = AttentionFn.layout_copies
    got = AttentionFn.apply(q, k, v)
    torch.cuda.synchronize()
    assert AttentionFn.layout_copies == copies and got.shape == q.shape
    ref = attention_plain(q, k, v).float()
    tol = attn_tol(ref, dtype, cap=float("inf"))
    assert (got.float() - ref).abs().max().item() <= tol
    assert min(attn_mutant_errs(q, k, v)) > tol


@pytest.mark.parametrize("which", ["lcm", "if"])
def test_lcm_and_if_bf16_forward_launch_counts(which):
    """One full-width bf16 forward on the card, LCM Dreamshaper v7 at batch
    1 (with its guidance embedding) and IF-I-M at the CFG batch 2: finite
    output of the expected shape, and the launch counters read exactly the
    calls of tests/_torch_if_shapes.py (61 GN + 32 attention; 117 + 22)."""
    _card()
    from loco_edit_tpu_torch.models.ifm import IFUNet, if_preset
    from loco_edit_tpu_torch.models.sd import SDUNet, sd_preset
    from _torch_sd_shapes import SD_UNET_GN_SHAPES

    gen = torch.Generator("cuda").manual_seed(2)
    with torch.device("cuda"):
        if which == "lcm":
            m = SDUNet(sd_preset("lcm-dreamshaper-v7", dtype=torch.bfloat16))
            args = (torch.randn(1, 64, 64, 4, device="cuda", generator=gen), 759.0,
                    0.2 * torch.randn(1, *LCM_CONTEXT, device="cuda", generator=gen),
                    torch.full((1,), 6.5, device="cuda"))
            shapes, want = (SD_UNET_GN_SHAPES, LCM_ATTN_SHAPES), (1, 64, 64, 4)
        else:
            m = IFUNet(if_preset("IF-I-M", dtype=torch.bfloat16))
            args = (torch.randn(2, 64, 64, 3, device="cuda", generator=gen), 742.5,
                    0.2 * torch.randn(2, *IF_CONTEXT, device="cuda", generator=gen))
            shapes, want = (IF_I_M_GN_SHAPES, IF_I_M_ATTN_SHAPES), (2, 64, 64, 6)
    m.init_random_(gen).requires_grad_(False)
    gn0, at0 = group_norm_cuda.launches, flash_attention_cuda.launches
    with torch.no_grad():
        out = m(*args)
    torch.cuda.synchronize()
    assert out.shape == want and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert group_norm_cuda.launches - gn0 == sum(shapes[0].values())
    assert flash_attention_cuda.launches - at0 == sum(shapes[1].values())


def _tiny_sam_on(device: str):
    """A tiny SAM encoder (windowed + global, padded windows) and decoder
    with seeded weights, the rel-pos tables and the positional embedding
    redrawn so that they carry signal; CPU copies of the same weights."""
    from loco_edit_tpu_torch.masks.sam_decoder import SamDecoderConfig, SamMaskDecodeModel
    from loco_edit_tpu_torch.masks.sam_vit import SamViTConfig, SamViTEncoder

    cfg = SamViTConfig(image_size=64, patch_size=8, hidden_size=64, num_layers=3,
                       num_heads=4, mlp_ratio=2.0, window_size=3, global_attn_indexes=(1,),
                       output_channels=32)
    dcfg = SamDecoderConfig(hidden_size=32, num_pos_feats=16, num_attention_heads=2,
                            mlp_dim=64, iou_head_hidden_dim=16, image_embedding_size=8,
                            input_image_size=64, mask_input_channels=8)
    g = torch.Generator(device).manual_seed(0)
    with torch.device(device):
        enc, dec = SamViTEncoder(cfg), SamMaskDecodeModel(dcfg)
    enc.init_random_(g, std=0.1)
    dec.init_random_(g, pe_scale=2.0, std=0.1)
    with torch.no_grad():
        for n, p in enc.named_parameters():
            if "rel_pos" in n or n == "pos_embed":
                p.normal_(0.0, 0.1, generator=g)
    cpu = []
    for m in (enc, dec):
        with torch.device("cpu"):
            c = type(m)(m.cfg)
        c.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        cpu.append(c.eval())
    return enc.eval(), dec.eval(), *cpu


# the full-width f32 FFHQ_P2 eps, card against CPU, relative to its largest
# value, under the port's policy on an H100: full f32 reads 5.9e-6 on
# chip_smoke phase 3's input; TF32 convolutions (10-bit mantissas, 2^-11
# rounding of each operand) read 8.65e-4 there and 9.75e-4 on this test's
# input. The bound lies between them, 34 times above the one and 4.3 times
# below the other
F32_P2_RTOL = 2e-4


def _rel(a, b) -> float:
    return ((a.float().cpu() - b.float()).abs().max() / b.float().abs().max()).item()


def test_sam_encoder_on_card_matches_cpu():
    """The tiny SAM encoder in f32 on the card against the CPU: summation
    order only (1e-4 of the largest output)."""
    _card()
    enc, _, cpu_enc, _ = _tiny_sam_on("cuda")
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = enc(x.cuda()), cpu_enc(x)
    assert got.shape == want.shape == (2, 8, 8, 32)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("case", ["points", "boxes_mask"])
def test_sam_decoder_on_card_matches_cpu(case):
    """The tiny SAM decoder on the card against the CPU (1e-4 of the largest
    logit and IoU): point labels 1, 0, -10 and -1; boxes with an input-mask
    dense prompt and single-mask output."""
    _card()
    _, dec, _, cpu_dec = _tiny_sam_on("cuda")
    g = torch.Generator().manual_seed(2)
    emb = torch.randn(1, 8, 8, 32, generator=g)
    kw = dict(points=torch.rand(1, 3, 3, 2, generator=g) * 64,
              labels=torch.tensor([[[1, 0, -10], [1, 1, 0], [0, -1, 1]]], dtype=torch.int32))
    if case == "boxes_mask":
        kw = dict(boxes=torch.tensor([[[4.0, 4.0, 40.0, 50.0], [10.0, 2.0, 60.0, 30.0]]]),
                  input_masks=torch.randn(1, 32, 32, 1, generator=g))
    multi = case == "points"
    with torch.no_grad():
        got = dec(emb.cuda(), multimask_output=multi, **{k: v.cuda() for k, v in kw.items()})
        want = cpu_dec(emb, multimask_output=multi, **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _rel(a, b) <= 1e-4


def test_f32_loader_sets_full_f32_policy():
    """From PyTorch's default (TF32 convolutions) an f32 loader switches the
    process to the port's f32 policy (core/device.py::use_full_f32), and the
    full-width f32 P2 eps then agrees with the CPU within F32_P2_RTOL of its
    largest value; the same forward with TF32 convolutions, under the same
    measured choice of algorithm, does not (chip_smoke phase 3 prints both
    readings for its own input)."""
    _card()
    from loco_edit_tpu_torch.models.registry import load_adm_denoiser

    torch.backends.cudnn.allow_tf32 = True
    den = load_adm_denoiser("FFHQ_P2", dtype=torch.float32, device="cuda", seed=0)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.benchmark
    model = den.meta["model"]
    with torch.device("cpu"):
        cpu = type(model)(model.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.randn(1, 256, 256, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got, want = model(x.cuda(), 595.0), cpu.requires_grad_(False).eval()(x, 595.0)
        assert _rel(got, want) <= F32_P2_RTOL
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = model(x.cuda(), 595.0)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    assert _rel(tf32, want) > F32_P2_RTOL


def test_batched_f32_convs_under_the_policy_match_float64_and_avoid_fft():
    """Under the port's f32 policy (core/device.py::use_full_f32: TF32 off,
    cuDNN's measured choice of algorithm), in the layouts P2 runs them
    (forward on channels_last activations, input gradient on NCHW ones, as
    the basis's vjp computes it):

    - a batch-9 3x3 convolution at P2's widest shape (256 x 256, 128 -> 128)
      and its input gradient match a float64 CPU computation within 1e-4 of
      the largest output: f32 sums of 1152 products land near 1e-6, TF32
      operands (2^-11 each) near 4e-4, and the same calls with TF32 on must
      miss it;
    - after one warm call the profiler records no FFT-tiling kernel (a name
      with fft or cf32) in the two P2 passes where cuDNN's heuristic takes
      one and is slower: the strips' batch-9 forward of the 256 -> 128 3x3
      convolution at 128 x 128 (about 420 against 2.3 ms on an H100) and the
      basis's batch-5 input gradient of the 128 -> 128 one at 256 x 256
      (about 5.0 against 3.8 ms). At the batch-9 input gradient above, which
      no P2 path runs, measurement keeps an FFT engine: the fastest there
      (docs/CONV_CHOICE_P2.md).
    """
    _card()
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from loco_edit_tpu_torch.core.device import use_full_f32

    def fprop(x, w):
        return F.conv2d(x, w, padding=1)

    def dgrad(dy, w):
        n, _, h, wd = dy.shape
        x = dy.new_empty(n, w.shape[1], h, wd)
        return torch.ops.aten.convolution_backward(
            dy, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, False, False])[0]

    def kernels(run):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}

    b = torch.backends
    saved = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark
    use_full_f32(torch.float32)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(9, 256, 256, 128, generator=g).permute(0, 3, 1, 2)
    w = torch.randn(128, 128, 3, 3, generator=g) / 34.0        # ~1 / sqrt(1152)
    dy = torch.randn(9, 128, 256, 256, generator=g)
    want_y = F.conv2d(x.double().contiguous(), w.double(), padding=1)
    want_dx = F.conv_transpose2d(dy.double(), w.double(), padding=1)
    xc, wc, dyc = x.cuda(), w.cuda(), dy.cuda()
    gc = torch.Generator("cuda").manual_seed(6)
    x128 = torch.randn(9, 128, 128, 256, device="cuda", generator=gc).permute(0, 3, 1, 2)
    w256 = torch.randn(128, 256, 3, 3, device="cuda", generator=gc) / 48.0
    try:
        for run, want in ((lambda: fprop(xc, wc), want_y), (lambda: dgrad(dyc, wc), want_dx)):
            got = run()
            torch.cuda.synchronize()
            assert got.shape == want.shape and _rel(got, want) <= 1e-4
            b.cudnn.allow_tf32 = True
            try:
                assert _rel(run(), want) > 1e-4
            finally:
                b.cudnn.allow_tf32 = False
        for run in (lambda: fprop(x128, w256), lambda: dgrad(dyc[:5], wc)):
            names = kernels(run)
            assert names, "the profiler recorded no kernel"
            assert not [n for n in names if "fft" in n.lower() or "cf32" in n], names
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark = saved


def test_metrics_and_lpips_on_card_match_cpu():
    """SSIM, masked MSE and LPIPS (alex and vgg, seeded weights, 64 px) on
    the card against the CPU: 1e-5 absolute for the metrics in [0, 1] and
    1e-4 relative for LPIPS (full-f32 convolutions both sides)."""
    _card()
    import copy

    from loco_edit_tpu_torch.utils import metrics
    from loco_edit_tpu_torch.utils.lpips import LPIPS, LPIPSMetric

    g = torch.Generator().manual_seed(5)
    a, b = torch.rand(2, 64, 64, 3, generator=g), torch.rand(2, 64, 64, 3, generator=g)
    mask = torch.rand(2, 64, 64, 1, generator=g) > 0.5
    for fn, extra in ((metrics.ssim, {}), (metrics.masked_mse, {"mask": mask})):
        got = fn(a.cuda(), b.cuda(), **{k: v.cuda() for k, v in extra.items()})
        want = fn(a, b, **extra)
        assert got.device.type == "cuda" and (got.cpu() - want).abs().max() <= 1e-5
    for net in ("alex", "vgg"):
        model = LPIPS(net)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * (2.0 / p[0].numel()) ** 0.5
                        if p.ndim == 4 else torch.rand(p.shape, generator=g))
        card = LPIPSMetric(copy.deepcopy(model).cuda())
        got, want = card(a, b, normalize=True), LPIPSMetric(model)(a, b, normalize=True)
        assert got.device.type == "cuda" and _rel(got.cpu(), want) <= 1e-4


def test_tiny_served_edit_on_card_launches_both_kernels(tmp_path):
    """The port's server on the card (TinyTest, f32): one /edit over HTTP
    launches both kernels, the uint8 strip is to_uint8 of the float one,
    and /invert answers in the request's shape."""
    _card()
    import base64
    import json
    import threading
    import urllib.request

    import numpy as np

    from loco_edit_tpu_torch.cli.args import parse_args, preset
    from loco_edit_tpu_torch.serve import EditService, make_server
    from loco_edit_tpu_torch.utils.io import to_uint8

    svc = EditService(preset(parse_args([
        "--model_name", "TinyTest", "--dataset_name", "Random", "--device", "cuda",
        "--for_steps", "8", "--inv_steps", "8", "--edit_t", "0.6",
        "--performance_boosting_t", "0.2", "--x_space_guidance_num_step", "2",
        "--pca_rank", "1", "--pca_rank_null", "1", "--vis_num", "1",
        "--null_space_projection", "true", "--seed", "3",
        "--result_folder", str(tmp_path)])))
    svc.pipe.cfg.save_images = False
    srv = make_server(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(url + path, data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    def strip(out):
        dt = np.uint8 if out["dtype"] == "uint8" else np.float32
        return np.frombuffer(base64.b64decode(out["strips"]["0"]), dt).reshape(out["shape"])

    try:
        group_norm_cuda.launches = flash_attention_cuda.launches = 0
        req = {"seed": 4, "mask_bbox": [8, 20, 8, 20], "sample_name": "card"}
        svc.pipe._boost_calls = 0
        out_f = post("/edit", dict(req, pixel=False))
        assert group_norm_cuda.launches > 0 and flash_attention_cuda.launches > 0
        svc.pipe._boost_calls = 0
        out_u = post("/edit", req)
        assert out_f["null_space_projection"] and np.isfinite(strip(out_f)).all()
        np.testing.assert_array_equal(strip(out_u), to_uint8(strip(out_f)))
        img = np.zeros((1, 32, 32, 3), np.float32)
        inv = post("/invert", {"image": base64.b64encode(img.tobytes()).decode()})
        assert inv["shape"] == [1, 32, 32, 3]
    finally:
        srv.shutdown()


# -- the 3xTF32 convolution route (ops/conv.py) -------------------------------


@pytest.mark.parametrize("shape, channels_last, chunks", [
    ((2, 3, 7, 5), True, 1),        # rows of 3: one value a step
    ((2, 64, 16, 16), True, 1),     # 16-byte vectors
    ((2, 64, 16, 16), True, 4),     # chunks of 16 channels
    ((2, 64, 16, 16), False, 2),    # NCHW in: copied to channels_last
    ((3, 6, 3, 3), False, 3),       # chunks of 2 channels: one value a step
])
def test_split_kernel_matches_plain(shape, channels_last, chunks):
    """csrc/conv_split.cu against ops/conv.py::split_plain, bit for bit, in
    the layout the route hands cuDNN: hi in runs of the channels, each a
    channels_last tensor of its own, and the pair [hi, lo]."""
    _card()
    from loco_edit_tpu_torch.ops.conv import split_cuda, split_plain

    t = torch.randn(shape, generator=torch.Generator().manual_seed(8)) * 3.0
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    his, pair = split_cuda(t.cuda(), chunks)
    torch.cuda.synchronize()
    hi, want_pair = split_plain(t)
    assert len(his) == chunks
    for got, want in zip(his, hi.chunk(chunks, dim=1)):
        assert got.shape == want.shape and torch.equal(got.cpu(), want)
        assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(pair.cpu(), want_pair)
    assert pair.is_contiguous(memory_format=torch.channels_last)


def _flags_f32():
    b = torch.backends
    return b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32


def test_if_ii_l_convolution_takes_the_3xtf32_route():
    """An IF-II-L convolution of the upscale (batch 6 = 3 frames x 2 CFG
    variants, 256 -> 256, 3x3 at 256 x 256) under the f32 policy takes the
    3xTF32 route (the recorder counts its operations in conv_tc_gflop),
    matches a float64 CPU convolution within 3e-5 of the largest output,
    and leaves the process's TF32 flags off. f32 FMA sums of 2304 products
    land near 2e-6, the tensor cores' truncated sums in one accumulator
    near 7e-6 (ops/conv.py), TF32-rounded operands near 3e-4."""
    _card()
    from loco_edit_tpu_torch.core.device import use_full_f32
    from loco_edit_tpu_torch.ops import conv
    from loco_edit_tpu_torch.utils.logger import start_recording, stop_recording

    use_full_f32(torch.float32)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(6, 256, 256, 256, generator=g).contiguous(memory_format=torch.channels_last)
    w, b = torch.randn(256, 256, 3, 3, generator=g) / 48.0, torch.randn(256, generator=g)
    xc, wc, bc = x.cuda(), torch.nn.Parameter(w.cuda()), b.cuda()
    start_recording()
    try:
        with torch.no_grad():
            y = conv.conv2d(xc, wc, bc, 1, 1)
        torch.cuda.synchronize()
    finally:
        rec = stop_recording()
    counts = rec.counts[None]
    gflop = 2 * 6 * 256 * 256 * 256 * 256 * 9 / 1e9
    assert counts["conv_gflop"] == counts.get("conv_tc_gflop") == pytest.approx(gflop), counts
    assert _flags_f32() == (False, False)
    want = torch.nn.functional.conv2d(x[:1].double(), w.double(), b.double(), padding=1)
    err = _rel(y[:1], want)
    print(f"IF-II-L 256->256 3x3 at 256x256 b6: 3xTF32 against f64 {err:.3g}, "
          f"{conv.chunks(256, 9)} chunks")
    assert err <= 3e-5


def test_route_rules_on_card_match_float64(monkeypatch):
    """The route's rules on the card, every call on 3xTF32 (its size floor
    set aside), at a P2-like basis shape (96 -> 96, 3x3 at 256 x 256, one
    image, 3 probes): the forward, vmap(jvp) with the probes folded into
    the batch and vmap(vjp) through ConvInputGradFn (on autograd's thread),
    each within 1e-5 of the largest output of a float64 CPU computation;
    the three calls counted once each in the request; the process's TF32
    flags stay off."""
    _card()
    from loco_edit_tpu_torch.core.device import use_full_f32
    from loco_edit_tpu_torch.ops import conv
    from loco_edit_tpu_torch.ops.conv import Conv2d
    from loco_edit_tpu_torch.utils.logger import span, start_recording, stop_recording

    monkeypatch.setattr(conv, "MIN_FLOP", 0)
    use_full_f32(torch.float32)
    torch.manual_seed(10)
    m = Conv2d(96, 96, 3, padding=1).requires_grad_(False)
    cpu = torch.nn.Conv2d(96, 96, 3, padding=1).double().requires_grad_(False)
    cpu.load_state_dict({k: v.double() for k, v in m.state_dict().items()})
    m = m.cuda()
    g = torch.Generator().manual_seed(11)
    x = torch.randn(1, 96, 256, 256, generator=g).contiguous(memory_format=torch.channels_last)
    probes = torch.randn(3, *x.shape, generator=g)
    def passes(f, x0, v):
        """f(x0), the tangents of f at x0 along v's rows, and the
        cotangents of v's rows."""
        tangents = torch.func.vmap(lambda t: torch.func.jvp(f, (x0,), (t,))[1])(v)
        _, vjp_fn = torch.func.vjp(f, x0)
        return [f(x0), tangents, torch.func.vmap(vjp_fn)(v)[0]]

    start_recording()
    try:
        with span("request"):
            got = passes(m, x.cuda(), probes.cuda())
            torch.cuda.synchronize()
    finally:
        rec = stop_recording()
    want = passes(cpu, x.double(), probes.double())
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5
    # the forward, jvp's primal and vjp's primal; not the tangent or input gradient
    (counts,) = [c for r, c in rec.counts.items() if r is not None]
    gflop = 3 * 2 * 256 * 256 * 96 * 96 * 9 / 1e9
    assert counts["conv_gflop"] == counts.get("conv_tc_gflop") == pytest.approx(gflop), counts
    assert _flags_f32() == (False, False)


def test_f32_p2_eps_on_the_route_keeps_the_full_f32_bound(monkeypatch):
    """The full-width f32 FFHQ_P2 eps, card against CPU, relative to its
    largest value, with every convolution of 8 channels or more on 3xTF32
    (the size floor and the 1x1 rule set aside: at batch 1 most of P2's
    convolutions stay with PyTorch), with the route off (full-f32
    cuDNN alone) and with TF32 convolutions: 3xTF32 stays within
    F32_P2_RTOL, as full f32 does; TF32 does not. The three readings are
    printed."""
    _card()
    from loco_edit_tpu_torch.models.registry import load_adm_denoiser
    from loco_edit_tpu_torch.ops import conv
    from loco_edit_tpu_torch.utils.logger import start_recording, stop_recording

    den = load_adm_denoiser("FFHQ_P2", dtype=torch.float32, device="cuda", seed=0)
    model = den.meta["model"]
    with torch.device("cpu"):
        cpu = type(model)(model.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.randn(1, 256, 256, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = cpu.requires_grad_(False).eval()(x, 595.0)
        start_recording()
        try:
            with monkeypatch.context() as mp:
                mp.setattr(conv, "MIN_FLOP", 0)
                mp.setattr(conv, "MIN_1X1_OUT", 0)
                route = _rel(model(x.cuda(), 595.0), want)
        finally:
            rec = stop_recording()
        with monkeypatch.context() as mp:
            mp.setattr(conv, "takes_route", lambda *a: False)
            full = _rel(model(x.cuda(), 595.0), want)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = _rel(model(x.cuda(), 595.0), want)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    counts = rec.counts[None]
    print(f"FFHQ_P2 f32 eps against the CPU: route {route:.3g} "
          f"({counts.get('conv_tc_gflop', 0):.2f} of {counts['conv_gflop']:.2f} GFLOP "
          f"3xTF32), full f32 {full:.3g}, TF32 {tf32:.3g}")
    # all but the 3- and 6-channel ends
    ends = [m for m in model.modules() if isinstance(m, conv.Conv2d) and min(m.weight.shape[:2]) < 8]
    end_gflop = sum(conv.gemm_flop((1, m.in_channels, 256, 256), m.weight.shape,
                                   conv.Geometry(m.stride, m.padding, m.dilation))
                    for m in ends) / 1e9
    assert len(ends) == 2
    assert counts["conv_tc_gflop"] == pytest.approx(counts["conv_gflop"] - end_gflop)
    assert route <= F32_P2_RTOL and full <= F32_P2_RTOL < tf32

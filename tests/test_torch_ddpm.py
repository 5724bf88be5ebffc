"""The port's DDPM U-Net and checkpoint converters against the JAX package:
the same parameters (carried from Flax, or converted from the same synthetic
torch state_dicts by both packages), the same inputs, f32."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.diffusion.scheduler import pmp as jax_pmp
from loco_edit_tpu.models.adm import ADMConfig as JaxADMConfig
from loco_edit_tpu.models.adm.convert import convert_adm_state_dict as jax_convert_adm
from loco_edit_tpu.models.ddpm import DDPMConfig as JaxDDPMConfig
from loco_edit_tpu.models.ddpm import DDPMUNet as JaxDDPMUNet
from loco_edit_tpu.models.ddpm import convert_ddpm_state_dict as jax_convert_sdedit
from loco_edit_tpu.models.ddpm import convert_diffusers_unet2d_state_dict as jax_convert_diffusers
from loco_edit_tpu.models.registry import save_params_npz
from loco_edit_tpu_torch.diffusion.scheduler import pmp
from loco_edit_tpu_torch.models.adm import ADMUNet
from loco_edit_tpu_torch.models.adm.config import (AttnSpec, ConvSpec, ResSpec,
                                                   SampleSpec, adm_layout)
from loco_edit_tpu_torch.models.adm.convert import (convert_adm_state_dict,
                                                    load_torch_checkpoint)
from loco_edit_tpu_torch.models.adm.presets import tiny_test_config
from loco_edit_tpu_torch.models.convert_util import check_state_dict, flax_to_state_dict
from loco_edit_tpu_torch.models.ddpm import (DDPMConfig, DDPMUNet,
                                             convert_ddpm_state_dict,
                                             convert_diffusers_unet2d_state_dict,
                                             ddpm_preset, ddpm_timestep_embedding)
from loco_edit_tpu_torch.models.ddpm.loader import ddpm_state_dict_from_file
from loco_edit_tpu_torch.models.registry import adm_params_from_flax
from _torch_ddpm_shapes import (DDPM_ATTN_SHAPES, DDPM_GN_EPS, DDPM_GN_SHAPES,
                                DDPM_PARAMS, ddpm_call_shapes)
from _torch_p2_shapes import P2_GN_SHAPES

torch.set_num_threads(2)

# the tiny config of tests/test_ddpm_convert.py: two levels, attention at 16
TINY = dict(resolution=32, in_channels=3, out_ch=3, ch=32, ch_mult=(1, 2),
            num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True)


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}


@pytest.fixture(scope="module")
def pair():
    """The tiny DDPM in both packages with the same weights: Flax init from
    jax.random.key(0), carried by flax_to_state_dict."""
    jm = JaxDDPMUNet(JaxDDPMConfig(**TINY))
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), 500.0)
    tm = DDPMUNet(DDPMConfig(**TINY))
    sd = flax_to_state_dict(_flat(params))
    check_state_dict(sd, tm, "Flax params")
    tm.load_state_dict(sd)
    tm.requires_grad_(False).eval()
    return jm, params, tm


def _x(seed, b=2):
    return np.random.default_rng(seed).normal(size=(b, 32, 32, 3)).astype(np.float32)


def test_timestep_embedding_matches_jax():
    """sin/cos of t * freq with t up to 999, where one f32 ulp of the
    argument is 6e-5: within 1e-4 (exp and sin of two libraries)."""
    from loco_edit_tpu.models.ddpm import ddpm_timestep_embedding as jax_emb

    t = np.array([0.0, 3.5, 412.7, 999.0], np.float32)
    for dim in (32, 33, 128):
        ref = np.asarray(jax_emb(jnp.asarray(t), dim))
        got = ddpm_timestep_embedding(torch.from_numpy(t), dim)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("t", [3.0, 412.7, 999.0])
def test_tiny_forward_matches_flax(pair, t):
    """f32 convolutions summed in another order by XLA and by PyTorch: within
    1e-4 of the largest |eps|."""
    jm, params, tm = pair
    x = _x(0)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), t))
    got = tm(torch.from_numpy(x), t)
    assert got.shape == ref.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max())


def test_pmp_jacobian_products_match(pair):
    """J v and J^T u of x -> pmp(x, eps(x, t)) through the tiny DDPM, with
    the probe axis vmapped as the subspace iteration does: within 1e-4 of
    the largest |value|."""
    jm, params, tm = pair
    t, ab = 600.0, 0.2
    x = _x(2, b=1)
    rng = np.random.default_rng(3)
    tan = rng.normal(size=(3,) + x.shape).astype(np.float32)
    cot = rng.normal(size=(3,) + x.shape).astype(np.float32)

    fj = lambda z: jax_pmp(z, jm.apply(params, z, t), ab)        # noqa: E731
    jv = np.asarray(jax.jit(jax.vmap(
        lambda v: jax.jvp(fj, (jnp.asarray(x),), (v,))[1]))(jnp.asarray(tan)))
    vj = np.asarray(jax.jit(jax.vmap(
        lambda u: jax.vjp(fj, jnp.asarray(x))[1](u)[0]))(jnp.asarray(cot)))

    ft = lambda z: pmp(z, tm(z, t), ab)                            # noqa: E731
    xt = torch.from_numpy(x)
    tjv = torch.func.vmap(lambda v: torch.func.jvp(ft, (xt,), (v,))[1])(
        torch.from_numpy(tan))
    _, tpull = torch.func.vjp(ft, xt)
    tvj = torch.func.vmap(lambda u: tpull(u)[0])(torch.from_numpy(cot))
    np.testing.assert_allclose(tjv.numpy(), jv, atol=1e-4 * np.abs(jv).max())
    np.testing.assert_allclose(tvj.numpy(), vj, atol=1e-4 * np.abs(vj).max())


def test_flax_npz_carry_is_exact(pair, tmp_path):
    """A .npz written by the JAX package's save_params_npz loads into the
    port bit for bit (kernels transposed, scale -> weight)."""
    _, params, tm = pair
    path = str(tmp_path / "ddpm.npz")
    save_params_npz(path, params)
    sd = ddpm_state_dict_from_file(path, DDPMConfig(**TINY))
    flat = _flat(params)
    assert len(sd) == len(flat)
    for name, ref in tm.state_dict().items():
        assert torch.equal(sd[name], ref), name
    np.testing.assert_array_equal(
        sd["down_0_block_0.conv1.weight"].numpy(),
        flat["params/down_0_block_0/conv1/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["mid_attn_1.q.weight"].numpy(),
                                  flat["params/mid_attn_1/q/kernel"].T)


# -- synthetic torch state_dicts through both packages' converters ---------------

class _Synth:
    """Seeded synthetic state_dict: add(name, *shape) makes name.weight of
    that shape and name.bias of its first dim."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.sd = {}

    def add(self, name, *shape):
        self.sd[f"{name}.weight"] = self.rng.normal(size=shape).astype(np.float32) * 0.05
        self.sd[f"{name}.bias"] = self.rng.normal(size=shape[0]).astype(np.float32) * 0.05


def _synth_ddpm(naming: str) -> dict:
    """SDEdit ("sdedit": 1x1 conv q/k/v) or diffusers ("diffusers": Linear
    to_q/to_k/to_v/to_out.0) naming of the tiny config."""
    s = _Synth(0 if naming == "sdedit" else 1)
    ch, mults = TINY["ch"], TINY["ch_mult"]
    in_mult = (1,) + mults
    nres, nlev, temb = TINY["num_res_blocks"], len(mults), 4 * ch
    sdedit = naming == "sdedit"

    def res(base, cin, cout):
        s.add(f"{base}.norm1", cin)
        s.add(f"{base}.conv1", cout, cin, 3, 3)
        s.add(f"{base}.{'temb_proj' if sdedit else 'time_emb_proj'}", cout, temb)
        s.add(f"{base}.norm2", cout)
        s.add(f"{base}.conv2", cout, cout, 3, 3)
        if cin != cout:
            s.add(f"{base}.{'nin_shortcut' if sdedit else 'conv_shortcut'}",
                  cout, cin, 1, 1)

    def attn(base, c):
        if sdedit:
            s.add(f"{base}.norm", c)
            for n in ("q", "k", "v", "proj_out"):
                s.add(f"{base}.{n}", c, c, 1, 1)
        else:
            s.add(f"{base}.group_norm", c)
            for n in ("to_q", "to_k", "to_v", "to_out.0"):
                s.add(f"{base}.{n}", c, c)

    def down(i, j):
        return f"down.{i}.block.{j}" if sdedit else f"down_blocks.{i}.resnets.{j}"

    s.add("temb.dense.0" if sdedit else "time_embedding.linear_1", temb, ch)
    s.add("temb.dense.1" if sdedit else "time_embedding.linear_2", temb, temb)
    s.add("conv_in", ch, 3, 3, 3)
    s.add("norm_out" if sdedit else "conv_norm_out", ch)
    s.add("conv_out", 3, ch, 3, 3)
    curr = TINY["resolution"]
    for i in range(nlev):
        cin, cout = ch * in_mult[i], ch * mults[i]
        for j in range(nres):
            res(down(i, j), cin if j == 0 else cout, cout)
            if curr in TINY["attn_resolutions"]:
                attn(f"down.{i}.attn.{j}" if sdedit
                     else f"down_blocks.{i}.attentions.{j}", cout)
        if i != nlev - 1:
            s.add(f"down.{i}.downsample.conv" if sdedit
                  else f"down_blocks.{i}.downsamplers.0.conv", cout, cout, 3, 3)
            curr //= 2
    c_mid = ch * mults[-1]
    res("mid.block_1" if sdedit else "mid_block.resnets.0", c_mid, c_mid)
    attn("mid.attn_1" if sdedit else "mid_block.attentions.0", c_mid)
    res("mid.block_2" if sdedit else "mid_block.resnets.1", c_mid, c_mid)
    block_in = c_mid
    for i in reversed(range(nlev)):
        k = nlev - 1 - i                    # diffusers' up_blocks index
        cout = ch * mults[i]
        for j in range(nres + 1):
            skip = ch * (in_mult[i] if j == nres else mults[i])
            base = f"up.{i}.block.{j}" if sdedit else f"up_blocks.{k}.resnets.{j}"
            res(base, block_in + skip, cout)
            block_in = cout
            if TINY["resolution"] // 2 ** i in TINY["attn_resolutions"]:
                attn(f"up.{i}.attn.{j}" if sdedit
                     else f"up_blocks.{k}.attentions.{j}", cout)
        if i != 0:
            s.add(f"up.{i}.upsample.conv" if sdedit
                  else f"up_blocks.{k}.upsamplers.0.conv", cout, cout, 3, 3)
    return s.sd


@pytest.mark.parametrize("naming", ["sdedit", "diffusers"])
def test_ddpm_converters_match_jax(naming):
    """Both packages' converters give the same parameters from one synthetic
    state_dict, and the port's result fits the model exactly."""
    sd = _synth_ddpm(naming)
    jax_conv, conv = ((jax_convert_sdedit, convert_ddpm_state_dict) if naming == "sdedit"
                      else (jax_convert_diffusers, convert_diffusers_unet2d_state_dict))
    ref = flax_to_state_dict(_flat(jax_conv(sd, JaxDDPMConfig(**TINY))))
    got = conv(sd, DDPMConfig(**TINY))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    check_state_dict(got, DDPMUNet(DDPMConfig(**TINY)), naming)
    # the torch tensors of a real checkpoint file convert alike
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert all(torch.equal(conv(tsd, DDPMConfig(**TINY))[k], got[k]) for k in got)


def _synth_adm(cfg) -> dict:
    """guided-diffusion naming of an ADM config, walked from its layout."""
    s = _Synth(2)
    mc = cfg.model_channels
    ted = 4 * mc
    s.add("time_embed.0", ted, mc)
    s.add("time_embed.2", ted, ted)
    layout = adm_layout(cfg)

    def seq(prefix, specs):
        for j, spec in enumerate(specs):
            t = f"{prefix}.{j}"
            if isinstance(spec, ConvSpec):
                s.add(t, spec.out_ch, spec.in_ch, 3, 3)
            elif isinstance(spec, ResSpec):
                e = 2 * spec.out_ch if cfg.use_scale_shift_norm else spec.out_ch
                s.add(f"{t}.in_layers.0", spec.in_ch)
                s.add(f"{t}.in_layers.2", spec.out_ch, spec.in_ch, 3, 3)
                s.add(f"{t}.emb_layers.1", e, ted)
                s.add(f"{t}.out_layers.0", spec.out_ch)
                s.add(f"{t}.out_layers.3", spec.out_ch, spec.out_ch, 3, 3)
                if spec.in_ch != spec.out_ch:
                    s.add(f"{t}.skip_connection", spec.out_ch, spec.in_ch, 1, 1)
            elif isinstance(spec, AttnSpec):
                s.add(f"{t}.norm", spec.ch)
                s.add(f"{t}.qkv", 3 * spec.ch, spec.ch, 1)
                s.add(f"{t}.proj_out", spec.ch, spec.ch, 1)
            elif isinstance(spec, SampleSpec) and spec.use_conv:
                s.add(f"{t}.conv" if spec.up else f"{t}.op", spec.out_ch, spec.in_ch, 3, 3)

    for i, specs in enumerate(layout.input_blocks):
        seq(f"input_blocks.{i}", specs)
    seq("middle_block", layout.middle_block)
    for i, specs in enumerate(layout.output_blocks):
        seq(f"output_blocks.{i}", specs)
    s.add("out.0", layout.out_ch_final)
    s.add("out.2", cfg.out_channels, layout.out_ch_final, 3, 3)
    return s.sd


ADM_CASES = {
    # P2-like: scale-shift norm, resblock up/down, 2 heads of 16 at 32 ch
    "p2_like": dict(),
    # legacy layout: standalone up/downsample convs, plain norm, 2 heads
    "legacy_updown": dict(num_res_blocks=2, attention_ds=(4,), num_heads=2,
                          num_head_channels=-1, use_scale_shift_norm=False,
                          resblock_updown=False),
}


@pytest.mark.parametrize("new_order", [False, True])
@pytest.mark.parametrize("case", sorted(ADM_CASES))
def test_adm_converter_matches_jax(case, new_order, tmp_path):
    """convert_adm_state_dict of both packages on one guided-diffusion-named
    synthetic state_dict (legacy head-interleaved or new q|k|v qkv packing)
    gives the same parameters; the port's also loads from a .pt file through
    load_torch_checkpoint."""
    cfg = tiny_test_config(**ADM_CASES[case])
    jcfg = JaxADMConfig(**{f.name: getattr(cfg, f.name)
                           for f in cfg.__dataclass_fields__.values()
                           if f.name != "dtype"})
    sd = _synth_adm(cfg)
    ref = adm_params_from_flax(_flat(jax_convert_adm(sd, jcfg, new_order)), cfg)
    got = convert_adm_state_dict(sd, cfg, new_order)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    path = str(tmp_path / "adm.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    from_file = convert_adm_state_dict(load_torch_checkpoint(path), cfg, new_order)
    model = ADMUNet(cfg)
    model.load_state_dict(from_file)
    assert all(torch.equal(from_file[k], got[k]) for k in got)


def test_celeba_hq_hf_structure_on_meta():
    """CelebA_HQ_HF on the meta device (never built for real on the CPU):
    the parameter count and the 71 GroupNorm (eps 1e-6) and 6 attention
    call shapes of one forward, which the card's tests and chip_smoke.py
    take as constants."""
    with torch.device("meta"):
        model = DDPMUNet(ddpm_preset("CelebA_HQ_HF", dtype=torch.bfloat16))
    assert sum(p.numel() for p in model.parameters()) == DDPM_PARAMS
    norms = [m for n, m in model.named_modules() if n.split(".")[-1].startswith("norm")]
    assert len(norms) == 71 and all(m.weight.dtype == torch.float32 for m in norms)
    assert model.conv_out.weight.dtype == torch.float32
    gn, attn, eps = ddpm_call_shapes()
    assert dict(gn) == DDPM_GN_SHAPES and sum(gn.values()) == 71
    assert dict(attn) == DDPM_ATTN_SHAPES and sum(attn.values()) == 6
    assert eps == {DDPM_GN_EPS}
    # every DDPM GroupNorm shape is a P2 one: only eps is new to the kernel
    assert set(DDPM_GN_SHAPES) <= set(P2_GN_SHAPES)

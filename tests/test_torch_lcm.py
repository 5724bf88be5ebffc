"""The port's LCM engine against the JAX package on the CPU: the LCM grid
bit for bit, the tiny LCM U-Net's guidance embedding (cond_proj) at two
guidance scales, the pipeline (z_t at edit_t_idx, the fused dual basis by
subspace overlap with the same probes, the strip, delta_zt_via_grad) with
the same inter-step noise injected through noise_fn, and the LCM CLI on
--device cpu."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.core.rng import seed_everything as jax_seed
from loco_edit_tpu.diffusion.lcm import lcm_grid as jax_lcm_grid
from loco_edit_tpu.models.sd.text import fake_prompt_encoder as jax_fake
from loco_edit_tpu.pipelines.lcm import LCMEditConfig as JaxConfig
from loco_edit_tpu.pipelines.lcm import LCMEditPipeline as JaxPipeline
from loco_edit_tpu_torch.cli import main
from loco_edit_tpu_torch.core import rng as torch_rng
from loco_edit_tpu_torch.diffusion.lcm import lcm_grid
from loco_edit_tpu_torch.models import t2i_registry
from loco_edit_tpu_torch.models.sd.text import fake_prompt_encoder
from loco_edit_tpu_torch.pipelines.lcm import LCMEditConfig, LCMEditPipeline
from _torch_port_utils import JaxDraws, lcm_tiny_pair, sd_tiny_pairs
from _torch_sd_utils import STRIP_RTOL, ZT_RTOL, _close, _files, _overlap

torch.set_num_threads(2)

# f32 agreement of the two frameworks through the tiny U-Net (as
# tests/test_torch_sd_models.py): 1e-5 of the largest |eps|
RTOL = 1e-5
SETTINGS = dict(num_inference_steps=4, edit_t_idx=2, guidance_scale=7.5,
                x_space_guidance_scale=1.0, x_space_guidance_num_step=1, vis_num=1,
                pca_rank=2, pca_rank_null=2, min_iter=1, max_iter=2,
                non_semantic=True, null_space_projection=True)
PROMPTS = ("a man", "a man with glasses")


def _noise(i, shape, dtype):
    """The inter-step noise both samplers get through noise_fn."""
    return np.random.default_rng(100 + i).normal(size=shape).astype(np.float32)


def _mask():
    m = np.zeros((1, 16, 16, 3), bool)
    m[:, 4:12, 3:11] = True
    return m


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_lcm_grid_matches_jax_bit_for_bit(n):
    got, ref = lcm_grid(n), jax_lcm_grid(n)
    for f in ("t", "alpha_bar", "alpha_bar_prev", "c_skip", "c_out"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if n == 4:
        np.testing.assert_array_equal(got.t, [999, 759, 519, 279])


@pytest.fixture(scope="module")
def lcm():
    junet, pu, unet = lcm_tiny_pair()
    return dict(junet=junet, pu=pu, unet=unet, sd=sd_tiny_pairs(),
                apply=jax.jit(junet.apply))


@pytest.mark.parametrize("w", [0.0, 6.5])
def test_lcm_unet_guidance_embedding_matches_jax(lcm, w):
    """f32 eps of the tiny LCM U-Net (time_cond_proj_dim=16) at guidance
    embeddings w = 0 and 6.5, the weights carried by the SD carry; the
    embedding moves eps, so cond_proj is in the path."""
    rng = np.random.default_rng(7)
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = (rng.normal(size=(2, 7, 32)) * 0.2).astype(np.float32)
    wv = np.full((2,), w, np.float32)
    ref = lcm["apply"](lcm["pu"], jnp.asarray(z), 400.0, jnp.asarray(ctx),
                       jnp.asarray(wv))
    got = lcm["unet"](torch.from_numpy(z), 400.0, torch.from_numpy(ctx),
                      torch.from_numpy(wv))
    _close(got.numpy(), ref, RTOL)
    assert "cond_proj.weight" in lcm["unet"].state_dict()
    other = lcm["unet"](torch.from_numpy(z), 400.0, torch.from_numpy(ctx),
                        torch.from_numpy(wv + 3.0))
    assert (other - got).abs().max().item() > 1e3 * RTOL * got.abs().max().item()


@pytest.fixture(scope="module")
def pipes(lcm, tmp_path_factory):
    """Both pipelines over the same weights and draws (the port gets the
    JAX package's probe and zT draws of jax.random.key(5) through JaxDraws,
    and both samplers the same noise through noise_fn), each run once."""
    P = lcm["sd"]
    root = tmp_path_factory.mktemp("lcm")
    jpipe = JaxPipeline(
        unet_apply=lambda z, t, c, w: lcm["junet"].apply(lcm["pu"], z, t, c, w),
        decode=lambda z: P["jdec"].apply(P["pd"], z), prompt_encoder=jax_fake(32, seq=7),
        cfg=JaxConfig(result_folder=str(root / "jax"), **SETTINGS), rng=jax_seed(5),
        latent_shape=(8, 8, 4))
    tpipe = LCMEditPipeline(
        unet_apply=lcm["unet"], decode=P["dec"],
        prompt_encoder=fake_prompt_encoder(32, seq=7, device="cpu"),
        cfg=LCMEditConfig(result_folder=str(root / "torch"), **SETTINGS),
        rng=JaxDraws(jax.random.key(5)), latent_shape=(8, 8, 4), device="cpu")
    jpipe.noise_fn = _noise
    tpipe.noise_fn = _noise
    out = {}
    for name, p in (("jax", jpipe), ("torch", tpipe)):
        out[name] = p.run_edit_null_space_projection_zt(*PROMPTS, mask=_mask(),
                                                        sample_name="s0")
    return jpipe, tpipe, out


def test_lcm_edit_matches_jax(pipes):
    """z_t at edit_t_idx, the fused dual basis projected into the null
    space (subspace overlap with matched probes), the strip's latents and
    decoded frames, and the same artifact files."""
    jpipe, tpipe, out = pipes
    j, t = out["jax"], out["torch"]
    _close(t["zt"], j["zt"], ZT_RTOL)
    _overlap(t["vT"], j["vT"])
    np.testing.assert_allclose(np.linalg.norm(t["vT"], axis=1), 1.0, rtol=1e-4)
    _close(t["denoised"], j["denoised"], STRIP_RTOL)
    _close(t["image"], j["image"], STRIP_RTOL)
    assert t["image"].shape == (3, 16, 16, 3)
    assert (_files(tpipe.cfg.result_folder) == _files(jpipe.cfg.result_folder)
            == ["s0/basis/vT.npz", "s0/edit-lcm-idx2.png"])
    assert set(tpipe.timings) == {"generate", "basis", "strips", "io"}


def test_lcm_delta_zt_via_grad_matches_jax(pipes):
    """The prompt-delta direction at the edit's z_t, masked: the same unit
    direction (|cosine| above 0.9999)."""
    jpipe, tpipe, out = pipes
    zt = out["jax"]["zt"]
    ref = np.asarray(jpipe.delta_zt_via_grad(jnp.asarray(zt), *PROMPTS, _mask()))
    got = tpipe.delta_zt_via_grad(zt, *PROMPTS, _mask()).numpy()
    assert got.shape == (1, 8 * 8 * 4)
    _overlap(got, ref)


def test_lcm_forward_steps_fresh_noise_per_call(lcm, tmp_path):
    """Without noise_fn, each forward_steps call draws a fresh stream: two
    calls from the same latent differ after the first re-noising."""
    P = lcm["sd"]
    tpipe = LCMEditPipeline(
        unet_apply=lcm["unet"], decode=P["dec"],
        prompt_encoder=fake_prompt_encoder(32, seq=7, device="cpu"),
        cfg=LCMEditConfig(result_folder=str(tmp_path), **SETTINGS),
        rng=JaxDraws(jax.random.key(5)), latent_shape=(8, 8, 4), device="cpu")
    z = np.random.default_rng(3).normal(size=(1, 8, 8, 4)).astype(np.float32)
    a, _ = tpipe.forward_steps(z, "a man", 0, 2)
    b, _ = tpipe.forward_steps(z, "a man", 0, 2)
    assert (a - b).abs().max().item() > 1e-3


LCM_CLI = ["--model_name", "LCM_Dreamshaper_v7", "--dataset_name", "Random",
           "--for_prompt", "a man", "--edit_prompt", "a man with glasses",
           "--guidance_scale", "7.5", "--num_inference_steps", "4", "--edit_t_idx", "2",
           "--x_space_guidance_scale", "1.0", "--x_space_guidance_num_step", "1",
           "--vis_num", "1", "--pca_rank", "2", "--pca_rank_null", "2",
           "--non_semantic", "true", "--null_space_projection", "true",
           "--use_mask", "true", "--use_yh_custom_scheduler", "false",
           "--run_ddim_forward", "true", "--run_edit_null_space_projection_zt", "true",
           "--seed", "5", "--device", "cpu"]


def test_lcm_cli_on_cpu(lcm, tmp_path, monkeypatch):
    """The LCM CLI on the CPU with the tiny LCM bundle: the cached mask.npz,
    LCMforward.png, the edit's artifacts; z_t is the pipeline's from the
    same seed (the JAX package's draws), the directions unit-norm."""
    P = lcm["sd"]
    bundle = t2i_registry.sd_bundle(lcm["unet"], P["enc"], P["dec"],
                                    fake_prompt_encoder(32, seq=7, device="cpu"))
    monkeypatch.setattr(t2i_registry, "load_sd_bundle", lambda *a, **k: bundle)
    monkeypatch.setattr(torch_rng, "seed_everything",
                        lambda seed: JaxDraws(jax.random.key(seed)))
    d = tmp_path / "LCM-Random-" / "results" / "mask"
    os.makedirs(d)
    np.savez(d / "mask.npz", masks=_mask())
    res = main.main(LCM_CLI + ["--result_folder", str(tmp_path)])
    edit = res["edit"]
    assert res["forward"].shape == (5, 16, 16, 3) and np.isfinite(res["forward"]).all()
    np.testing.assert_allclose(np.linalg.norm(edit["vT"], axis=1), 1.0, rtol=1e-4)
    assert np.isfinite(edit["image"]).all() and edit["image"].shape == (3, 16, 16, 3)
    files = _files(str(tmp_path / "LCM-Random-" / "results"))
    assert {"LCMforward.png", "sample/basis/vT.npz",
            "sample/edit-lcm-idx2.png"} <= set(files)
    tpipe = LCMEditPipeline(
        unet_apply=lcm["unet"], decode=P["dec"],
        prompt_encoder=fake_prompt_encoder(32, seq=7, device="cpu"),
        cfg=LCMEditConfig(result_folder=str(tmp_path / "direct"), **SETTINGS),
        rng=JaxDraws(jax.random.key(5)), latent_shape=(8, 8, 4), device="cpu")
    zT = tpipe.rng.fork("zT").normal((1, 8, 8, 4), device="cpu")
    tpipe._noise_calls = 1       # the CLI's LCMforward call drew the first stream
    zt, _ = tpipe.forward_steps(zT, "a man", 0, 2)
    _close(edit["zt"], zt.numpy(), 1e-6)

"""The port's DeepFloyd-IF engine against the JAX package on the CPU, over
the tiny stage-1 IF U-Net with the same carried weights and the JAX
package's draws (JaxDraws): z_t at edit_t, the direct and Jacobian
directions, the fused subspace basis, the DiffEdit mask and masked sampler,
the stage-2 SuperResSampler (its noise the same draws); then the IF CLI on
--device cpu with the DiffEdit mask and a stage-2 checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.core.rng import seed_everything as jax_seed
from loco_edit_tpu.masks.diffedit import diffedit_mask as jax_diffedit_mask
from loco_edit_tpu.models.sd.text import fake_prompt_encoder as jax_fake
from loco_edit_tpu.pipelines.deepfloyd import IFEditConfig as JaxConfig
from loco_edit_tpu.pipelines.deepfloyd import IFEditPipeline as JaxPipeline
from loco_edit_tpu.pipelines.superres import SuperResSampler as JaxSR
from loco_edit_tpu.pipelines.superres import _bilinear_align_corners as jax_bilinear
from loco_edit_tpu_torch.cli import main
from loco_edit_tpu_torch.core import rng as torch_rng
from loco_edit_tpu_torch.models.sd.text import fake_prompt_encoder
from loco_edit_tpu_torch.pipelines.deepfloyd import IFEditConfig, IFEditPipeline
from loco_edit_tpu_torch.pipelines.superres import SuperResSampler, _bilinear_align_corners
from _torch_port_utils import JaxDraws, if_tiny_pair
from _torch_sd_utils import STRIP_RTOL, ZT_RTOL, _close, _files, _overlap
from test_if_convert import synthetic_if_state_dict

torch.set_num_threads(2)

SETTINGS = dict(for_steps=8, edit_t=0.75, guidance_scale=7.0, guidance_scale_edit=4.0,
                pca_rank=2, pca_rank_null=2, min_iter=1, max_iter=2,
                x_space_guidance_num_step=2, vis_num=1)
PROMPTS = ("a dog", "a dog wearing a hat")


def _mask():
    m = np.zeros((1, 16, 16, 3), bool)
    m[:, 3:11, 5:13] = True
    return m


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both pipelines over the tiny stage-1 pair's weights, the port fed the
    JAX package's draws of jax.random.key(9); z_T and z_t at edit_t."""
    junet, params, unet = if_tiny_pair()
    root = tmp_path_factory.mktemp("if")
    jp = JaxPipeline(lambda x, t, c: junet.apply(params, x, t, c), jax_fake(48, seq=7),
                     JaxConfig(result_folder=str(root / "jax"), **SETTINGS),
                     jax_seed(9), sample_shape=(16, 16, 3))
    tp = IFEditPipeline(unet, fake_prompt_encoder(48, seq=7, device="cpu"),
                        IFEditConfig(result_folder=str(root / "torch"), **SETTINGS),
                        JaxDraws(jax.random.key(9)), sample_shape=(16, 16, 3),
                        device="cpu")
    xT = np.asarray(jax.random.normal(jp.rng.fork("xT").key, (1, 16, 16, 3)))
    jprompts, tprompts = jp.prompt_set(*PROMPTS), tp.prompt_set(*PROMPTS)
    jxt = np.asarray(jp.forward_steps(xT, jprompts, "null+(for-null)", 0, jp.edit_t_idx))
    txt = tp.forward_steps(xT, tprompts, "null+(for-null)", 0, tp.edit_t_idx).numpy()
    return dict(jp=jp, tp=tp, junet=junet, params=params, unet=unet, xT=xT, jxt=jxt,
                txt=txt, jprompts=jprompts, tprompts=tprompts)


def test_if_grid_and_xt_match_jax(engines):
    """The squaredcos_cap_v2 grid at t_max 990 and the CFG trajectory to
    edit_t on the eps half of the learned-sigma output."""
    jp, tp = engines["jp"], engines["tp"]
    assert tp.edit_t_idx == jp.edit_t_idx
    for f in ("t", "alpha_bar", "alpha_bar_next"):
        np.testing.assert_array_equal(getattr(tp.gen_grid, f), getattr(jp.gen_grid, f))
    _close(engines["txt"], engines["jxt"], ZT_RTOL)


def test_if_direct_direction_matches_jax(engines):
    """get_v_modify without a Jacobian: an epsilon combination at x_t (the
    reference script's (for-edit)-direct); the other direct modes are the
    same CFG combinations (tests/test_torch_sd_models.py holds cfg_eps in
    every mode)."""
    mode = "(for-edit)-direct"
    ref = np.asarray(engines["jp"].direct_direction(engines["jxt"], engines["jprompts"], mode))
    got = engines["tp"].direct_direction(engines["jxt"], engines["tprompts"], mode).numpy()
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, rtol=1e-5)
    _overlap(got, ref)


def test_if_jacobian_direction_matches_jax(engines):
    """The prompt-delta Jacobian direction in pixel space, masked."""
    mode = "null+(for-null)+(edit-null)"
    ref = np.asarray(engines["jp"].delta_xt_via_grad(engines["jxt"], engines["jprompts"],
                                                     _mask(), mode))
    got = engines["tp"].delta_xt_via_grad(engines["jxt"], engines["tprompts"], _mask(),
                                          mode).numpy()
    _overlap(got, ref)


def test_if_dual_basis_matches_jax(engines):
    """The fused modify + null subspace iteration of the PMP Jacobian with
    the same probes: both bases by subspace overlap."""
    args = (engines["jxt"],)
    jb, jn = engines["jp"].extract_dual_basis(*args, engines["jprompts"], "null+(for-null)",
                                              _mask(), 2, 2)
    tb, tn = engines["tp"].extract_dual_basis(*args, engines["tprompts"], "null+(for-null)",
                                              _mask(), 2, 2)
    assert tb.iters == int(jb.iters)
    _overlap(tb.vT.numpy(), np.asarray(jb.vT))
    _overlap(tn.vT.numpy(), np.asarray(jn.vT))


def test_if_diffedit_mask_and_masked_sampler_match_jax(engines):
    """The DiffEdit mask of x_t (the JAX function with the same noise key,
    min-max normalized) and the masked sampler from edit_t under it."""
    jp, tp = engines["jp"], engines["tp"]
    x0 = engines["jxt"]
    f_for = jp._eps_fn(engines["jprompts"], "null+(for-null)")
    f_edit = jp._eps_fn(engines["jprompts"], "null+(edit-null)")
    ref = np.asarray(jax.jit(lambda x, k: jax_diffedit_mask(
        f_for, f_edit, x, jp.scheduler.schedule.alphas_cumprod, k))(
            jnp.asarray(x0), jp.rng.fork("diffedit").key))
    got = tp.diffedit_mask(x0, engines["tprompts"])
    assert got.shape == (1, 16, 16, 1) and got.dtype == bool
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.mean() < 1
    mask = np.repeat(got, 3, axis=-1)
    jm = np.asarray(jp.masked_forward_steps(x0, engines["jprompts"], mask,
                                            jp.edit_t_idx, None))
    tm = tp.masked_forward_steps(x0, engines["tprompts"], mask, tp.edit_t_idx, None)
    _close(tm.numpy(), jm, STRIP_RTOL)


def test_superres_sampler_matches_jax(tmp_path):
    """The stage-2 sampler on the tiny stage-2 U-Net (32 px, 4 steps, CFG
    4, aug level 250): align-corners upsampling, the noise-augmented
    conditioning and the DDIM draws from the same streams. The network's
    eps is x_t plus 0.05 x the tiny U-Net's in both packages: an untrained
    eps alone drives the state to |x| ~ 5e2 from t = 990 (1 / sqrt(abar) =
    71), where the clip to [-1, 1] would hide all but the rounding."""
    junet, params, unet = if_tiny_pair(stage2=True)

    def jnet(x, t, c, a):
        return 0.05 * junet.apply(params, x, t, c, a) + jnp.concatenate([x[..., :3]] * 2, -1)

    def tnet(x, t, c, a):
        return 0.05 * unet(x, t, c, a) + torch.cat([x[..., :3]] * 2, -1)

    low = (np.random.default_rng(0).normal(size=(2, 8, 8, 3)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(_bilinear_align_corners(torch.from_numpy(low), 32, 32).numpy(),
                               np.asarray(jax_bilinear(jnp.asarray(low), 32, 32)), atol=1e-6)
    kw = dict(out_size=32, steps=4, guidance_scale=4.0, aug_level=250)
    jsr = JaxSR(jnet, jax_fake(48, seq=7), rng=jax_seed(4), **kw)
    tsr = SuperResSampler(tnet, fake_prompt_encoder(48, seq=7, device="cpu"),
                          rng=JaxDraws(jax.random.key(4)), device="cpu", **kw)
    ref = np.asarray(jsr(low, "a dog"))
    got = tsr(low, "a dog")
    assert got.shape == (2, 32, 32, 3) and float(got.abs().max()) <= 1.0
    assert (np.abs(ref) < 1).mean() > 0.5
    _close(got.numpy(), ref, STRIP_RTOL)


IF_CLI = ["--model_name", "DeepFloyd-IF-I-M", "--dataset_name", "Random",
          "--for_prompt", "a dog", "--edit_prompt", "a dog wearing a hat",
          "--guidance_scale", "7.0", "--guidance_scale_edit", "4.0",
          "--for_steps", "8", "--edit_t", "0.75", "--performance_boosting_t", "0",
          "--x_space_guidance_scale", "1.0", "--x_space_guidance_num_step", "2",
          "--vis_num", "1", "--pca_rank", "1", "--null_space_projection", "false",
          "--tilda_v_score_type", "(for-edit)-direct",
          "--jacobian", "false", "--use_mask", "true", "--mask_type", "diffedit",
          "--run_ddim_forward", "true", "--run_edit_null_space_projection_xt_semantic",
          "true", "--seed", "1", "--device", "cpu"]


def test_if_cli_on_cpu_with_diffedit_mask(tmp_path, monkeypatch):
    """The IF CLI on the CPU: the tiny IF config without a checkpoint
    (LOCO_IF_PRESET=tiny: the tiny stage 1 alone, as the JAX package's
    bundle builds without files; the port's default is IF-I-M + IF-II-L), the
    DiffEdit mask of the sample the edit starts from, the semantic direct
    direction (the CLI's basis iterations run 10-50 sweeps, so the null-space
    projection is left to the pipeline tests), IFforward.png and the edit's
    artifacts; z_t is the pipeline's from the same seed. A stage-2
    checkpoint (synthetic, diffusers names) loads into the upscaler
    through infer_if_config."""
    monkeypatch.setenv("LOCO_IF_PRESET", "tiny")
    monkeypatch.setattr(torch_rng, "seed_everything",
                        lambda seed: JaxDraws(jax.random.key(seed)))
    res = main.main(IF_CLI + ["--result_folder", str(tmp_path)])
    edit, mask = res["edit"], res["mask"]
    assert res["forward"].shape == (5, 16, 16, 3) and np.isfinite(res["forward"]).all()
    assert mask.shape == (1, 16, 16, 3) and 0 < mask.mean() < 1
    assert edit["vT"].shape == (1, 16 * 16 * 3)
    np.testing.assert_allclose(np.linalg.norm(edit["vT"], axis=1), 1.0, rtol=1e-4)
    assert edit["image"].shape == (3, 16, 16, 3) and np.isfinite(edit["image"]).all()
    files = _files(str(tmp_path / "DeepFloyd-IF-Random-" / "results"))
    assert {"IFforward.png", "sample/basis/vT.npz", "sample/edit-if-stage1.png"} <= set(files)
    assert set(res["timings"]["edit"]) == {"generate", "basis", "strips", "io"}

    from loco_edit_tpu_torch.models import t2i_registry

    s2 = tmp_path / "stage2.pt"
    torch.save({k: torch.from_numpy(v) for k, v in
                synthetic_if_state_dict(stage2=True, seed=1).items()}, s2)

    class Args:
        checkpoint_path, stage2_checkpoint_path, text_encoder_path = "", str(s2), ""
        dtype, seed, device, stage2_guidance_scale = "fp32", 3, "cpu", 4.0

    b = t2i_registry.load_if_bundle(Args())
    m2 = b["models"]["stage2"]
    assert m2.cfg.class_embed_timestep and m2.cfg.sample_size == 256
    assert b["superres"].out_size == 256 and b["superres"].aug_level == 250
    x = torch.zeros(1, 16, 16, 6)
    assert torch.isfinite(m2(x, 500.0, b["prompt_encoder"]("a dog"), 250.0)).all()

"""Shared by the tests that hold the port's SDEditPipeline and SD CLI
against the JAX package's: pipelines over the tiny SD pair, tolerances and
comparisons."""

import os

import jax
import numpy as np

from loco_edit_tpu.core.rng import seed_everything as jax_seed
from loco_edit_tpu.models.sd.text import fake_prompt_encoder as jax_fake
from loco_edit_tpu.models.sd.vae import encode_sample as jax_encode_sample
from loco_edit_tpu.pipelines.sd import SDEditConfig as JaxConfig
from loco_edit_tpu.pipelines.sd import SDEditPipeline as JaxPipeline
from loco_edit_tpu_torch.models.sd.text import fake_prompt_encoder
from loco_edit_tpu_torch.models.sd.vae import encode_sample
from loco_edit_tpu_torch.pipelines.sd import SDEditConfig, SDEditPipeline
from _torch_port_utils import JaxDraws, sd_tiny_pairs

# f32 rounding of two frameworks through the CFG trajectory (the allowances
# of tests/test_torch_cli.py): z_t within 2e-5 of its largest |value|, the
# decoded strips and latents within 5e-5; bases by subspace overlap.
ZT_RTOL, STRIP_RTOL, OVERLAP = 2e-5, 5e-5, 0.9999
SETTINGS = dict(for_steps=8, inv_steps=8, edit_t=0.7, guidance_scale=5.0,
                pca_rank=2, pca_rank_null=2, min_iter=1, max_iter=2,
                x_space_guidance_num_step=2, vis_num=1, vis_num_pc=2)


def pipeline_factory(tmp_path_factory):
    """build(**SDEditConfig overrides) -> (JAX pipeline, port pipeline) over
    the tiny pair's weights, each in its own result folder, the port's fed
    the JAX package's draws of jax.random.key(3)."""
    P = sd_tiny_pairs()

    def build(**overrides):
        root = tmp_path_factory.mktemp("sd")
        kw = {**SETTINGS, **overrides}
        jcfg = JaxConfig(result_folder=str(root / "jax"), **kw)
        jpipe = JaxPipeline(
            unet_apply=lambda z, t, c: P["junet"].apply(P["pu"], z, t, c),
            decode=lambda z: P["jdec"].apply(P["pd"], z),
            encode=lambda x, key: jax_encode_sample(*P["jenc"].apply(P["pe"], x), key),
            prompt_encoder=jax_fake(32, seq=7), cfg=jcfg, rng=jax_seed(3),
            latent_shape=(8, 8, 4))
        tcfg = SDEditConfig(result_folder=str(root / "torch"), **kw)
        tpipe = SDEditPipeline(
            unet_apply=P["unet"], decode=P["dec"],
            encode=lambda x, rng: encode_sample(*P["enc"](x), rng),
            prompt_encoder=fake_prompt_encoder(32, seq=7, device="cpu"), cfg=tcfg,
            rng=JaxDraws(jax.random.key(3)), latent_shape=(8, 8, 4), device="cpu")
        return jpipe, tpipe

    return build


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=rtol * np.abs(ref).max())


def _overlap(a, b):
    """Subspace overlap of the row spaces (cosines of the principal angles)
    and row-by-row |cosine| of the unit directions, each above OVERLAP."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    qa, qb = np.linalg.qr(a.T)[0], np.linalg.qr(b.T)[0]
    cos = np.linalg.svd(qa.T @ qb, compute_uv=False)
    assert cos.min() > OVERLAP, cos
    rows = np.abs((a * b).sum(1)) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    assert rows.min() > OVERLAP, rows


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _box_mask():
    mask = np.zeros((1, 16, 16, 3), bool)      # pixel space (decoded size)
    mask[:, 4:12, 4:12] = True
    return mask


def _compare_edit(j, t):
    _close(t["zt"], j["zt"], ZT_RTOL)
    _overlap(t["vT"], j["vT"])
    np.testing.assert_allclose(np.linalg.norm(t["vT"], axis=1), 1.0, rtol=1e-4)
    assert sorted(t["strips"]) == sorted(j["strips"])
    for pc in j["strips"]:
        _close(t["strips"][pc], j["strips"][pc], STRIP_RTOL)
        _close(t["z0_strips"][pc], j["z0_strips"][pc], STRIP_RTOL)



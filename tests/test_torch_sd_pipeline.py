"""The port's SDEditPipeline against the JAX package's on the tiny SD U-Net
and VAE with the same carried weights and the JAX package's random draws
(zT, the VAE sample noise, the probes) fed through the port's RngStream
interface: the unsupervised dual-basis edit with null-space projection and
the SEGA branch of tests/test_pipeline_sd.py, and run_edit_batch against
the JAX package's and against single runs (tests/test_torch_sd_semantic.py
holds the text-supervised edit and the inversion)."""

import numpy as np
import pytest
import torch

from _torch_sd_utils import (STRIP_RTOL, _box_mask, _close, _compare_edit, _files,
                             pipeline_factory)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def make(tmp_path_factory):
    return pipeline_factory(tmp_path_factory)


def test_unsupervised_dual_basis_edit_with_null_space_matches_jax(make):
    """The fused modify + null bases of decode(PMP) under a pixel mask, the
    null-space projection, 2 PCs of 3-frame walks, denoised and decoded: the
    same z_t, basis, strips and artifact files."""
    jpipe, tpipe = make(null_space_projection=True)
    kw = dict(for_prompt="a cat", edit_prompt="", mask=_box_mask(), sample_name="s0")
    j = jpipe.run_edit_null_space_projection_zt(**kw)
    t = tpipe.run_edit_null_space_projection_zt(**kw)
    assert t["vT"].shape == (2, 8 * 8 * 4) and t["strips"][0].shape == (3, 16, 16, 3)
    _compare_edit(j, t)
    assert _files(t["out_dir"]) == _files(j["out_dir"])
    assert {"generate", "basis", "strips", "io"} <= set(tpipe.timings)


def test_sega_branch_matches_jax(make):
    jpipe, tpipe = make(use_sega=True)
    kw = dict(for_prompt="a cat", edit_prompt="smiling", sample_name="s2")
    j = jpipe.run_edit_null_space_projection_zt(**kw)
    t = tpipe.run_edit_null_space_projection_zt(**kw)
    assert t["image"].shape == (1, 16, 16, 3)
    _close(t["image"], j["image"], STRIP_RTOL)


@pytest.fixture(scope="module")
def batch(make):
    """Two real images inverted and generated to edit_t in one batch, then a
    basis and strips each (one box mask, and an all-False row meaning
    none), through both packages' run_edit_batch."""
    jpipe, tpipe = make(null_space_projection=False, vis_num_pc=1)
    rng = np.random.default_rng(1)
    x0s = rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    masks = np.concatenate([_box_mask(), np.zeros((1, 16, 16, 3), bool)])
    kw = dict(for_prompt="a dog", x0s=x0s, masks=masks, sample_names=["a", "b"])
    return jpipe, jpipe.run_edit_batch(**kw), tpipe, tpipe.run_edit_batch(**kw), kw


def test_run_edit_batch_matches_single_runs(make, batch):
    """The port's batch against two single runs on one pipeline from the
    same latents: the same z_t (within the batch size's summation order),
    bases, strips and artifact files."""
    _, _, tpipe, got, kw = batch
    assert {"invert", "generate", "basis", "strips", "io"} <= set(tpipe.timings)
    zTs = tpipe.invert(kw["x0s"])
    masks = kw["masks"]
    _, single = make(null_space_projection=False, vis_num_pc=1)
    for i, name in enumerate(["a", "b"]):
        ref = single.run_edit_null_space_projection_zt(
            "a dog", zT=zTs[i:i + 1], mask=masks[i:i + 1] if i == 0 else None,
            sample_name=name)
        _compare_edit(ref, got[i])
    assert _files(tpipe.cfg.result_folder) == _files(single.cfg.result_folder)


def test_run_edit_batch_matches_jax(batch):
    """Both packages' run_edit_batch on the same images and masks: the same
    z_t, bases, strips and artifact files per sample."""
    jpipe, j, tpipe, t, _ = batch
    assert len(t) == len(j) == 2
    for ji, ti in zip(j, t):
        _compare_edit(ji, ti)
    assert _files(tpipe.cfg.result_folder) == _files(jpipe.cfg.result_folder)

"""The port's SDEditPipeline against the JAX package's, as in
tests/test_torch_sd_pipeline.py: the text-supervised edit with a pixel mask
and the inversion of a real image, the remaining cases of
tests/test_pipeline_sd.py."""

import numpy as np
import pytest
import torch

from _torch_sd_utils import ZT_RTOL, _box_mask, _close, _compare_edit, pipeline_factory

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def make(tmp_path_factory):
    return pipeline_factory(tmp_path_factory)


def test_semantic_edit_with_pixel_mask_matches_jax(make):
    """The text-supervised direction (the prompt-delta VJP through the
    decoder, masked) projected off the complement-mask basis: a rank-1 unit
    direction equal to JAX's."""
    jpipe, tpipe = make(null_space_projection=True)
    kw = dict(for_prompt="a cat", edit_prompt="a cat with sunglasses",
              mask=_box_mask(), sample_name="s1", semantic=True)
    j = jpipe.run_edit_null_space_projection_zt(**kw)
    t = tpipe.run_edit_null_space_projection_zt(**kw)
    assert t["vT"].shape == (1, 8 * 8 * 4)
    _compare_edit(j, t)


def test_inversion_of_real_image_matches_jax(make):
    """A 16 px image through the VAE encoder (the JAX package's sample
    noise) and the ascending DDIM without CFG, plain and with one
    refinement step."""
    x0 = np.random.default_rng(0).normal(size=(1, 16, 16, 3)).astype(np.float32) * 0.4
    for refine in (0, 1):
        jpipe, tpipe = make(inv_refine_steps=refine)
        ref = np.asarray(jpipe.invert(x0, inv_prompt=""))
        got = tpipe.invert(x0, inv_prompt="").numpy()
        assert got.shape == (1, 8, 8, 4)
        _close(got, ref, ZT_RTOL)



"""The SD CLI through both packages: the tiny SD pair monkeypatched in as
each package's bundle, the JAX package's draws fed to the port, a cached
result_folder/mask/mask.npz selecting the edit region. The same artifact
tree, z_t, basis, strips and forward samples."""

import os

import jax
import numpy as np
import pytest
import torch

from loco_edit_tpu.cli import main as jax_main
from loco_edit_tpu.models import t2i_registry as jax_registry
from loco_edit_tpu.models.sd.text import fake_prompt_encoder as jax_fake
from loco_edit_tpu.models.sd.vae import encode_sample as jax_encode_sample
from loco_edit_tpu.pipelines.sd import SDEditPipeline as JaxPipeline
from loco_edit_tpu_torch.cli import main
from loco_edit_tpu_torch.core import rng as torch_rng
from loco_edit_tpu_torch.models import t2i_registry
from loco_edit_tpu_torch.models.sd.text import fake_prompt_encoder
from _torch_port_utils import JaxDraws, sd_tiny_pairs
from _torch_sd_utils import STRIP_RTOL, _close, _compare_edit, _files

torch.set_num_threads(2)

SD_CLI = ["--model_name", "stable-diffusion-tiny", "--dataset_name", "Random",
          "--for_prompt", "a cat", "--edit_prompt", "", "--guidance_scale", "5.0",
          "--for_steps", "8", "--inv_steps", "8", "--edit_t", "0.7",
          "--performance_boosting_t", "0", "--pca_rank", "2", "--pca_rank_null", "2",
          "--null_space_projection", "true", "--use_mask", "true", "--mask_index", "1",
          "--x_space_guidance_scale", "1.0", "--x_space_guidance_num_step", "2",
          "--vis_num", "1", "--run_ddim_forward", "true",
          "--run_edit_null_space_projection_zt", "true", "--seed", "3"]


def _write_mask(root):
    """masks (2, 16, 16, 3) bool at the path both CLIs read: two boxes,
    --mask_index 1 picks the second."""
    d = os.path.join(root, "Stable_Diffusion-Random-", "results", "mask")
    os.makedirs(d)
    masks = np.zeros((2, 16, 16, 3), bool)
    masks[0, :8] = True
    masks[1, 4:12, 6:14] = True
    np.savez(os.path.join(d, "mask.npz"), masks=masks)
    return masks[1:2]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    P = sd_tiny_pairs()
    jax_bundle = {
        "unet_apply": lambda z, t, c: P["junet"].apply(P["pu"], z, t, c),
        "decode": lambda z: P["jdec"].apply(P["pd"], z),
        "encode": lambda x, key: jax_encode_sample(*P["jenc"].apply(P["pe"], x), key),
        "prompt_encoder": jax_fake(32, seq=7), "latent_shape": (8, 8, 4)}
    bundle = t2i_registry.sd_bundle(P["unet"], P["enc"], P["dec"],
                                    fake_prompt_encoder(32, seq=7, device="cpu"))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_registry, "load_sd_bundle", lambda *a, **k: jax_bundle)
    mp.setattr(t2i_registry, "load_sd_bundle", lambda *a, **k: bundle)
    mp.setattr(torch_rng, "seed_everything", lambda seed: JaxDraws(jax.random.key(seed)))
    captured = {}

    def capture(name, fn):
        def wrapped(self, *a, **k):
            captured[name] = out = fn(self, *a, **k)
            return out
        return wrapped

    mp.setattr(JaxPipeline, "run_edit_null_space_projection_zt",
               capture("edit", JaxPipeline.run_edit_null_space_projection_zt))
    mp.setattr(JaxPipeline, "decode_to_image",
               capture("forward", JaxPipeline.decode_to_image))
    out = {}
    try:
        for pkg in ("jax", "torch"):
            root = str(tmp_path_factory.mktemp(pkg))
            mask = _write_mask(root)
            argv = SD_CLI + ["--result_folder", root]
            if pkg == "jax":
                jax_main.main(argv)
                res = dict(captured)
            else:
                res = main.main(argv + ["--device", "cpu"])
            out[pkg] = dict(root=root, mask=mask, **res)
    finally:
        mp.undo()
    return out


def test_sd_cli_edit_matches_jax(cli_runs):
    """The masked dual-basis edit with null-space projection through both
    CLIs: the same z_t, basis, strips and latents (the pipeline tests'
    tolerances), and the per-phase timings."""
    j, t = cli_runs["jax"], cli_runs["torch"]
    _compare_edit(j["edit"], t["edit"])
    assert t["edit"]["vT"].shape == (2, 8 * 8 * 4)
    assert {"generate", "basis", "strips", "io"} <= set(t["timings"]["edit"])


def test_sd_cli_forward_matches_jax(cli_runs):
    """--run_ddim_forward: five seeded samples generated with CFG and
    decoded."""
    j, t = cli_runs["jax"], cli_runs["torch"]
    assert t["forward"].shape == (5, 16, 16, 3)
    _close(t["forward"], j["forward"], STRIP_RTOL)


def test_sd_cli_artifact_tree_matches_jax(cli_runs):
    """Both CLIs write the same files: archived args.py, the mask cache,
    the forward samples, basis caches, the projected basis and the strips."""
    files = _files(cli_runs["torch"]["root"])
    assert files == _files(cli_runs["jax"]["root"])
    names = {os.path.basename(f) for f in files}
    assert {"args.py", "mask.npz", "DDIMforward.png", "vT.npz"} <= names
    assert sum(n.startswith("edit-zt-0.7T-pc") for n in names) == 2
    assert sum(n.startswith("vT-modify-") or n.startswith("vT-null-") for n in names) == 2


def test_sd_cli_without_a_mask_cache_raises(tmp_path):
    """--use_mask true with no cached mask runs SAM on the generated image;
    the default --mask_backend hf_pipeline with a hub name would fetch
    weights, so it raises before any model is built."""
    with pytest.raises(FileNotFoundError, match="hf_pipeline reads a local"):
        main.main(SD_CLI + ["--result_folder", str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("argv, error, match", [
    (["--model_name", "LCM_Dreamshaper"], FileNotFoundError, "hf_pipeline reads a local"),
    (["--model_name", "DeepFloyd-IF", "--mesh_data", "2"], ValueError,
     "needs 2 ranks, have 1"),
])
def test_other_t2i_families_raise(argv, error, match, tmp_path):
    """The LCM and IF engines run under these flags, and refuse what they
    cannot do before any model is built: LCM SAM masks from hub weights
    over hf_pipeline (never fetched), IF --mesh_data 2 in one process
    (make_mesh's ValueError, as the JAX CLI's with too few devices)."""
    with pytest.raises(error, match=match):
        main.main(SD_CLI + ["--result_folder", str(tmp_path), "--device", "cpu"] + argv)


def test_sd_zt_scale_lookup_and_presets_match_jax(tmp_path):
    """preset() of both packages on an SD run: latent geometry (4 x 64),
    memory bound 5, and the x-space-guidance scale looked up by h_t."""
    from loco_edit_tpu.cli import args as jax_args
    from loco_edit_tpu_torch.cli import args

    argv = ["--model_name", "stabilityai/stable-diffusion-2-1-base",
            "--performance_boosting_t", "0", "--use_x_space_guidance", "true",
            "--h_t", "0.7", "--seed", "2"]
    mine = vars(args.preset(args.parse_args(argv + ["--result_folder", str(tmp_path / "a")])))
    ref = vars(jax_args.preset(jax_args.parse_args(
        argv + ["--result_folder", str(tmp_path / "b")])))
    for k in ("is_stable_diffusion", "exp", "c_in", "image_size", "memory_bound",
              "x_space_guidance_scale"):
        assert mine[k] == ref[k], k
    assert (mine["c_in"], mine["image_size"], mine["memory_bound"]) == (4, 64, 5)
    assert mine["x_space_guidance_scale"] == 1

"""The SAM two-phase protocol through the port's CLI (--sampling_mode true
extracts and caches every mask, then exits 0; the rerun picks
--mask_index), at TinyTest size on the CPU, with a tiny SAM written as a
HF-named state_dict file and --mask_backend flax. The masks are held to
the JAX package's on the same image and weights: the same number, each
equal but for at most 0.1 % of its pixels (a threshold flip at a logit of
~0 is rounding, not a defect)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from loco_edit_tpu.cli import main as jax_main
from loco_edit_tpu.masks import sam as jax_sam
from loco_edit_tpu_torch.cli import main
from loco_edit_tpu_torch.masks import sam
from loco_edit_tpu_torch.models import t2i_registry
from loco_edit_tpu_torch.models.sd.text import fake_prompt_encoder
from loco_edit_tpu_torch.pipelines import UncondEditPipeline
from loco_edit_tpu_torch.pipelines.sd import SDEditPipeline
from loco_edit_tpu_torch.utils.io import to_uint8
from _torch_port_utils import sd_tiny_pairs, tiny_sam_model

torch.set_num_threads(2)

TINY = ["--model_name", "TinyTest", "--for_steps", "6", "--inv_steps", "6",
        "--edit_t", "0.6", "--performance_boosting_t", "0.2",
        "--x_space_guidance_scale", "0.5", "--x_space_guidance_num_step", "2",
        "--pca_rank", "1", "--pca_rank_null", "1", "--vis_num", "1", "--seed", "3",
        "--run_edit_null_space_projection", "true", "--null_space_projection", "true",
        "--use_mask", "true", "--mask_backend", "flax", "--filter_mask", "0"]


def _close_masks(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == bool
    for x, y in zip(a, b):
        assert (x != y).mean() <= 1e-3


@pytest.fixture(scope="module")
def sam_files(tmp_path_factory):
    """The tiny SAM (HF's 8 decoder heads, which a state_dict file implies)
    as a HF-named .pt for the port and a save_pretrained dir for JAX, and a
    one-image FFHQ-style folder."""
    d = tmp_path_factory.mktemp("sam")
    _, model = tiny_sam_model(decoder_heads=8)
    torch.save(model.state_dict(), d / "sam.pt")
    model.save_pretrained(d / "sam")
    ffhq = d / "ffhq"
    ffhq.mkdir()
    yy, xx = np.mgrid[:64, :64] / 64
    img = (np.random.default_rng(0).uniform(0, 60, (64, 64, 3))
           + 180 * np.stack([yy, xx, 1 - yy], -1)).astype(np.uint8)
    Image.fromarray(img).save(ffhq / "00000.png")
    return dict(pt=str(d / "sam.pt"), dir=str(d / "sam"), ffhq=str(ffhq), model=model)


def _mask_cache(root):
    found = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f == "mask.npz"]
    assert len(found) == 1, found
    with np.load(found[0]) as z:
        return found[0], z["masks"]


def test_uncond_two_phase_protocol(sam_files, tmp_path, monkeypatch):
    """FFHQ-style folder, TinyTest: --sampling_mode true exits 0 with
    sample_idx0/mask/mask.npz ((n, 32, 32, 3) bool, the JAX CLI's masks)
    and an overlay per mask; the --mask_index 0 rerun edits with mask 0."""
    common = TINY + ["--dataset_name", "FFHQ", "--dataset_root", sam_files["ffhq"]]
    troot, jroot = str(tmp_path / "torch"), str(tmp_path / "jax")
    for root, extra, run in (
            (troot, ["--mask_model_name", sam_files["pt"], "--device", "cpu"], main.main),
            (jroot, ["--mask_model_name", sam_files["dir"]], jax_main.main)):
        with pytest.raises(SystemExit) as e:
            run(common + extra + ["--sampling_mode", "true", "--result_folder", root])
        assert e.value.code == 0
    path, masks = _mask_cache(troot)
    assert path.endswith(os.path.join("results", "sample_idx0", "mask", "mask.npz"))
    assert masks.ndim == 4 and masks.shape[1:] == (32, 32, 3)
    assert np.array_equal(masks[..., 0], masks[..., 2])
    _close_masks(masks, _mask_cache(jroot)[1])
    pngs = sorted(f for f in os.listdir(os.path.dirname(path)) if f.endswith(".png"))
    assert pngs == [f"mask_{i:03d}.png" for i in range(len(masks))]

    seen = {}
    run_edit = UncondEditPipeline.run_edit_null_space_projection

    def capture(self, *a, **k):
        seen["mask"] = k["mask"]
        return run_edit(self, *a, **k)

    monkeypatch.setattr(UncondEditPipeline, "run_edit_null_space_projection", capture)
    out = main.main(common + ["--mask_model_name", sam_files["pt"], "--device", "cpu",
                              "--mask_index", "0", "--result_folder", troot])
    np.testing.assert_array_equal(seen["mask"], masks[:1])
    vT = out["edit"]["vT"]
    assert np.isfinite(vT).all()
    np.testing.assert_allclose(np.linalg.norm(vT, axis=1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("dataset", ["Random", "FFHQ"])
def test_uncond_cold_cache_raises(sam_files, dataset, tmp_path):
    """Without --sampling_mode a cold mask cache is an error, raised before
    any image is generated."""
    argv = TINY + ["--dataset_name", dataset, "--dataset_root", sam_files["ffhq"],
                   "--mask_model_name", sam_files["pt"], "--device", "cpu",
                   "--result_folder", str(tmp_path)]
    with pytest.raises(FileNotFoundError, match="run once with --sampling_mode true"):
        main.main(argv)


def test_random_dataset_sampling_mode_generates_lazily(sam_files, tmp_path, monkeypatch):
    """On the Random dataset SAM segments the generated x0 of the seeded
    xT: the one image handed to extract_and_cache_masks is pipe.generate's."""
    seen = []
    extract = sam.extract_and_cache_masks
    monkeypatch.setattr(sam, "extract_and_cache_masks",
                        lambda args, x0, path, **k: seen.append(x0) or extract(args, x0, path, **k))
    with pytest.raises(SystemExit) as e:
        main.main(TINY + ["--dataset_name", "Random", "--mask_model_name", sam_files["pt"],
                          "--device", "cpu", "--sampling_mode", "true",
                          "--result_folder", str(tmp_path)])
    assert e.value.code == 0
    assert len(seen) == 1 and seen[0].shape == (1, 32, 32, 3) and np.isfinite(seen[0]).all()
    assert _mask_cache(tmp_path)[1].shape[1:] == (32, 32, 3)


SD = ["--model_name", "stable-diffusion-tiny", "--dataset_name", "Random",
      "--for_prompt", "a cat", "--edit_prompt", "", "--guidance_scale", "5.0",
      "--for_steps", "6", "--inv_steps", "6", "--edit_t", "0.7",
      "--performance_boosting_t", "0", "--pca_rank", "1", "--pca_rank_null", "1",
      "--null_space_projection", "true", "--use_mask", "true", "--mask_index", "0",
      "--x_space_guidance_scale", "1.0", "--x_space_guidance_num_step", "2",
      "--vis_num", "1", "--run_edit_null_space_projection_zt", "true", "--seed", "3",
      "--mask_backend", "flax", "--filter_mask", "0", "--device", "cpu"]


def test_t2i_first_run_extracts_and_edits(sam_files, tmp_path, monkeypatch):
    """SD (tiny U-Net, 16 px VAE): a cold cache makes the generated image,
    caches its SAM masks at the image's side (the JAX CLI's
    segment_image_flax_encoder masks of the same image and weights) and the
    edit goes on with --mask_index 0; with --sampling_mode the run exits 0
    after caching."""
    P = sd_tiny_pairs()
    bundle = t2i_registry.sd_bundle(P["unet"], P["enc"], P["dec"],
                                    fake_prompt_encoder(32, seq=7, device="cpu"))
    monkeypatch.setattr(t2i_registry, "load_sd_bundle", lambda *a, **k: bundle)
    images, seen = [], {}
    extract = sam.extract_and_cache_masks
    monkeypatch.setattr(sam, "extract_and_cache_masks",
                        lambda args, x0, path, **k: images.append(x0) or extract(args, x0, path,
                                                                                 **k))
    run_zt = SDEditPipeline.run_edit_null_space_projection_zt

    def capture(self, *a, **k):
        seen["mask"] = k["mask"]
        return run_zt(self, *a, **k)

    monkeypatch.setattr(SDEditPipeline, "run_edit_null_space_projection_zt", capture)
    argv = SD + ["--mask_model_name", sam_files["pt"]]
    out = main.main(argv + ["--result_folder", str(tmp_path / "a")])
    path, masks = _mask_cache(tmp_path / "a")
    assert path.endswith(os.path.join("Stable_Diffusion-Random-", "results", "mask", "mask.npz"))
    assert images[0].shape == (1, 16, 16, 3) and masks.shape[1:] == (16, 16, 3)
    np.testing.assert_array_equal(seen["mask"], masks[:1])
    assert np.isfinite(out["edit"]["vT"]).all()
    want = jax_sam.segment_image_flax_encoder(to_uint8(images[0])[0], sam_files["model"],
                                              filter_mask=0, resolution=16)
    _close_masks(masks[..., 0], want)

    seen.clear()
    with pytest.raises(SystemExit) as e:
        main.main(argv + ["--sampling_mode", "true", "--result_folder", str(tmp_path / "b")])
    assert e.value.code == 0
    np.testing.assert_array_equal(_mask_cache(tmp_path / "b")[1], masks)
    assert not seen and len(images) == 2

"""The port's CLI, datasets, CelebAMask-HQ masks and batch / group edits
against the JAX package: the same flags and derived presets, the same
arrays from one synthetic CelebAMask-HQ tree, and the TinyTest edit through
both CLIs with the same weights and the JAX package's random draws."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from loco_edit_tpu.cli import args as jax_args
from loco_edit_tpu.cli import main as jax_main
from loco_edit_tpu.data import get_dataset as jax_get_dataset
from loco_edit_tpu.masks import CelebAMaskDataset as JaxCelebAMaskDataset
from loco_edit_tpu.pipelines import UncondEditPipeline as JaxPipeline
from loco_edit_tpu_torch.cli import args, main
from loco_edit_tpu_torch.core import rng as torch_rng
from loco_edit_tpu_torch.data import get_dataset
from loco_edit_tpu_torch.masks import CELEBA_SEMANTICS, CelebAMaskDataset
from loco_edit_tpu_torch.models import registry
from loco_edit_tpu_torch.models.base import Denoiser
from loco_edit_tpu_torch.pipelines import UncondEditConfig, UncondEditPipeline
from _torch_port_utils import JaxDraws, tiny_pair

torch.set_num_threads(2)


def write_celeba_tree(root, n=2, size=64, sems=("hair", "skin", "l_eye"), seed=0):
    """A CelebAMask-HQ tree: n images CelebA-HQ-img/{i}.jpg and binary masks
    CelebAMask-HQ-mask-anno/0/{i:05d}_{sem}.png (plus a stray file and a
    non-numeric directory the parser must skip)."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "CelebA-HQ-img")
    anno = os.path.join(root, "CelebAMask-HQ-mask-anno", "0")
    os.makedirs(img_dir)
    os.makedirs(anno)
    os.makedirs(os.path.join(root, "CelebAMask-HQ-mask-anno", "extra"))
    yy, xx = np.mgrid[:size, :size] / size
    for i in range(n):
        img = (rng.uniform(0, 1, (size, size, 3)) * 80
               + 120 * np.stack([yy, xx, 1 - yy], -1)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, f"{i}.jpg"))
        for k, sem in enumerate(sems):
            cy, cx = rng.uniform(0.3, 0.7, 2)
            r = 0.15 + 0.05 * k
            m = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.uint8) * 255
            Image.fromarray(m).save(os.path.join(anno, f"{i:05d}_{sem}.png"))
    open(os.path.join(anno, "notes.txt"), "w").close()
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_celeba_tree(str(tmp_path_factory.mktemp("celeba")))


# -- flags and presets ------------------------------------------------------------

def test_flag_surface_matches_jax():
    """The port parses every flag of the JAX package, with the same
    defaults, and adds only --device (default cuda)."""
    mine, ref = vars(args.parse_args([])), vars(jax_args.parse_args([]))
    assert mine.pop("device") == "cuda"
    assert mine == ref


def _rel(d, roots):
    out = dict(d)
    for k, v in d.items():
        if isinstance(v, str):
            for r in roots:
                v = v.replace(r, "<root>")
            out[k] = v
    return out


@pytest.mark.parametrize("argv", [
    ["--model_name", "CelebA_HQ_HF", "--dataset_name", "CelebA_HQ_mask",
     "--for_steps", "100", "--performance_boosting_t", "0.2",
     "--use_x_space_guidance", "true", "--h_t", "0.6", "--seed", "3"],
    ["--model_name", "FFHQ_P2", "--dataset_name", "FFHQ", "--for_steps", "100",
     "--performance_boosting_t", "0.2", "--memory_bound", "8", "--seed", "4"],
    ["--model_name", "TinyTest", "--dataset_name", "Random", "--seed", "5"],
])
def test_preset_derives_the_same_fields(argv, tmp_path):
    """preset() of both packages on the same flags: the same derived fields
    (family booleans, exp name, input geometry, memory bound, the scale
    looked up by h_t), with run folders under each one's own root."""
    roots = [str(tmp_path / "a"), str(tmp_path / "b")]
    mine = args.preset(args.parse_args(argv + ["--result_folder", roots[0]]))
    ref = jax_args.preset(jax_args.parse_args(argv + ["--result_folder", roots[1]]))
    mine = _rel(vars(mine), roots)
    assert mine.pop("device") == "cuda"
    assert mine == _rel(vars(ref), roots)
    assert os.path.isdir(os.path.join(roots[0], mine["exp"], "results"))


def test_preset_invariants_enforced(tmp_path):
    a = args.parse_args(["--model_name", "CelebA_HQ_HF", "--for_steps", "50",
                         "--performance_boosting_t", "0.2",
                         "--result_folder", str(tmp_path)])
    with pytest.raises(AssertionError):
        args.preset(a)


TINY_CLI = ["--model_name", "TinyTest", "--for_steps", "6", "--inv_steps", "6",
            "--edit_t", "0.6", "--performance_boosting_t", "0.2",
            "--x_space_guidance_scale", "0.5", "--x_space_guidance_num_step", "2",
            "--pca_rank", "2", "--pca_rank_null", "2", "--vis_num", "1",
            "--seed", "7", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    ["--mesh_probe", "2"], ["--mesh_data", "2"], ["--mesh_sp", "2"],
    ["--model_name", "stable-diffusion-tiny", "--mesh_probe", "2"],
    ["--model_name", "LCM_Dreamshaper", "--mesh_data", "2"],
    ["--model_name", "DeepFloyd-IF", "--mesh_sp", "2"],
])
def test_unported_flags_raise(extra, tmp_path):
    """The mesh flags are ported and honoured for every engine: in one
    process a mesh of 2 raises make_mesh's ValueError before any model is
    built (the JAX CLI's error with too few devices), and --mesh_sp on a
    T2I engine raises the port's ValueError (spatial parallelism runs the
    uncond engine). Their multi-rank runs: test_torch_parallel.py."""
    argv = TINY_CLI + ["--dataset_name", "Random", "--use_mask", "false",
                       "--result_folder", str(tmp_path), "--dataset_root", str(tmp_path)]
    t2i_sp = "--mesh_sp" in extra and "--model_name" in extra
    match = "uncond engine only" if t2i_sp else r"needs 2 ranks, have 1"
    with pytest.raises(ValueError, match=match):
        main.main(argv + extra)


@pytest.mark.parametrize("extra", [
    ["--trace_dir", "trace"], ["--verify_load", "ddpm"],
    ["--model_name", "LCM_Dreamshaper", "--pixel_output", "true"],
    ["--model_name", "DeepFloyd-IF", "--pixel_output", "true"],
])
def test_ported_flags_are_supported(extra):
    """--trace_dir, --verify_load and LCM/IF --pixel_output are ported:
    check_supported lets them through (their runs: test_torch_logger.py,
    test_torch_verify_load.py, test_torch_serve_t2i.py). No flag of the JAX
    CLI is left unported."""
    args.check_supported(args.parse_args(TINY_CLI + extra))
    assert list(args.UNPORTED) == []


# -- datasets and masks -------------------------------------------------------------

def test_celeba_mask_dataset_matches_jax(tree, tmp_path):
    mine = CelebAMaskDataset(tree, image_size=32, save_path=str(tmp_path / "a"))
    ref = JaxCelebAMaskDataset(tree, image_size=32, save_path=str(tmp_path / "b"))
    assert len(mine) == len(ref) == 2
    for i in range(2):
        np.testing.assert_array_equal(mine[i], ref[i])
        assert mine[i].shape == (1, 32, 32, 3) and mine[i].dtype == np.float32
        assert mine.available_semantics(i) == ref.available_semantics(i) \
            == ["hair", "l_eye", "skin"]
        for sem in ("hair", "skin", "l_eye"):
            m = mine.getmask(i, sem)
            np.testing.assert_array_equal(m, ref.getmask(i, sem))
            assert m.shape == (1, 32, 32, 3) and m.dtype == bool and 0 < m.mean() < 1
    assert sorted(os.listdir(tmp_path / "a")) == sorted(os.listdir(tmp_path / "b"))
    with pytest.raises(ValueError, match="not annotated"):
        mine.getmask(0, "hat")
    assert "hat" in CELEBA_SEMANTICS


def test_get_dataset_matches_jax(tree):
    for name, root in (("CelebA_HQ_mask", tree),
                       ("CelebA_HQ", os.path.join(tree, "CelebA-HQ-img"))):
        mine, ref = get_dataset(name, root, 32), jax_get_dataset(name, root, 32)
        assert type(mine).__name__ == type(ref).__name__ and len(mine) == len(ref)
        np.testing.assert_array_equal(mine[1], ref[1])
    assert get_dataset("Random") is None
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("NoSuchSet")


# -- the TinyTest edit through both CLIs ------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tree, tmp_path_factory):
    """Edit, then group edit with the two directions the edit wrote, through
    both CLIs: the JAX package's TinyTest weights carried into the port, and
    the JAX package's draws fed to the port's pipeline."""
    mp = pytest.MonkeyPatch()
    _, _, tm = tiny_pair()          # Flax init of key(0) + 0.02: JAX's TinyTest
    den = Denoiser(eps_fn=lambda z, t: tm(z, t), sample_shape=(32, 32, 3),
                   device=torch.device("cpu"), learn_sigma=True, meta={"model": tm})
    mp.setattr(registry, "load_tiny_denoiser", lambda *a, **k: den)
    mp.setattr(torch_rng, "seed_everything", lambda seed: JaxDraws(jax.random.key(seed)))
    captured = {}

    def capture(name, fn):
        def wrapped(self, *a, **k):
            out = fn(self, *a, **k)
            captured[name] = out
            return out
        return wrapped

    mp.setattr(JaxPipeline, "run_edit_null_space_projection",
               capture("edit", JaxPipeline.run_edit_null_space_projection))
    mp.setattr(JaxPipeline, "group_edit", capture("group", JaxPipeline.group_edit))
    common = TINY_CLI[:-2] + ["--dataset_name", "CelebA_HQ_mask", "--dataset_root",
                              tree, "--choose_sem", "hair", "--use_mask", "true",
                              "--null_space_projection", "true"]
    out = {}
    try:
        for pkg in ("jax", "torch"):
            root = str(tmp_path_factory.mktemp(pkg))
            argv = common + ["--result_folder", root]
            if pkg == "jax":
                jax_main.main(argv + ["--run_edit_null_space_projection", "true"])
                edit = captured["edit"]
            else:
                edit = main.main(argv + ["--device", "cpu",
                                         "--run_edit_null_space_projection", "true"])["edit"]
            basis = os.path.join(edit["out_dir"], "basis", "local_basis-0.6T")
            group_argv = argv + ["--group_edit_null_space_projection", "true",
                                 "--vT_path", os.path.join(basis, "pc_000-vT.npz"),
                                 "--vT1_path", os.path.join(basis, "pc_001-vT.npz")]
            if pkg == "jax":
                jax_main.main(group_argv)
                group = captured["group"]
            else:
                group = main.main(group_argv + ["--device", "cpu"])["group"]
            out[pkg] = dict(root=root, edit=edit, group=group)
    finally:
        mp.undo()
    return out


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_edit_matches_jax(cli_runs):
    """The same xt, the same basis up to float rounding, unit-norm
    directions and the same strips. JAX's TinyTest weights (+0.02) drive
    |xt| to ~40 and |strip| to ~150, so the tolerances are relative: f32
    rounding of two frameworks through the inversion (measured 8e-6 of the
    largest |xt|, held at 2e-5) and the boosted denoise (measured 1.2e-5 of
    the largest |strip|, held at 5e-5)."""
    j, t = cli_runs["jax"]["edit"], cli_runs["torch"]["edit"]
    np.testing.assert_allclose(t["xt"], j["xt"], atol=2e-5 * np.abs(j["xt"]).max())
    cos = np.linalg.svd(t["vT"] @ j["vT"].T, compute_uv=False)
    assert cos.min() > 0.9999, cos
    np.testing.assert_allclose(np.linalg.norm(t["vT"], axis=1), 1.0, rtol=1e-4)
    for pc in j["strips"]:
        np.testing.assert_allclose(t["strips"][pc], j["strips"][pc],
                                   atol=5e-5 * np.abs(j["strips"][pc]).max())


def test_cli_artifact_tree_matches_jax(cli_runs):
    """Both CLIs write the same files: archived args.py, the dataset image,
    basis caches, direction files, edit strips and the group edit."""
    files = _tree_files(cli_runs["torch"]["root"])
    assert files == _tree_files(cli_runs["jax"]["root"])
    names = {os.path.basename(f) for f in files}
    assert {"args.py", "image_0.png", "pc_000-vT.npz", "pc_001-vT.npz",
            "group_edit.png"} <= names
    assert any(n.startswith("edit-") and n.endswith(".png") for n in names)


def test_cli_group_edit_matches_jax(cli_runs):
    """Three frames (xt, + direction 0, + both), denoised with the boost
    tail: within the strips' tolerance (5e-5 of the largest |frame|)."""
    j, t = cli_runs["jax"]["group"], cli_runs["torch"]["group"]
    assert t.shape == j.shape == (3, 32, 32, 3) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, atol=5e-5 * np.abs(j).max())


def test_cli_forward_and_inversion_match_jax(tree, tmp_path, monkeypatch):
    """--run_ddim_forward and --run_ddim_inversion through the port's CLI:
    five seeded samples and the inverted dataset image, finite and saved as
    PNG grids; the inversion equals the JAX pipeline's on the same weights
    (2e-5 of the largest |xT|, the tolerance of test_cli_edit_matches_jax)."""
    from loco_edit_tpu.core.rng import seed_everything
    from loco_edit_tpu.models.registry import load_tiny_denoiser as jax_tiny
    from loco_edit_tpu.pipelines import UncondEditConfig as JaxConfig

    _, _, tm = tiny_pair()
    den = Denoiser(eps_fn=lambda z, t: tm(z, t), sample_shape=(32, 32, 3),
                   device=torch.device("cpu"))
    monkeypatch.setattr(registry, "load_tiny_denoiser", lambda *a, **k: den)
    out = main.main(TINY_CLI + ["--dataset_name", "CelebA_HQ_mask", "--dataset_root",
                                tree, "--use_mask", "false", "--run_ddim_forward", "true",
                                "--run_ddim_inversion", "true",
                                "--result_folder", str(tmp_path)])
    assert out["forward"].shape == (5, 32, 32, 3) and np.isfinite(out["forward"]).all()
    files = {os.path.basename(f) for f in _tree_files(str(tmp_path))}
    assert {"DDIMforward.png", "DDIMinversion.png"} <= files
    jpipe = JaxPipeline(jax_tiny(), JaxConfig(for_steps=6, inv_steps=6,
                                              result_folder=str(tmp_path / "jax")),
                        seed_everything(7))
    ref = np.asarray(jpipe.invert(JaxCelebAMaskDataset(tree, image_size=32)[0]))
    np.testing.assert_allclose(out["inversion"], ref, atol=2e-5 * np.abs(ref).max())


# -- batched edit -------------------------------------------------------------------

def test_run_edit_batch_matches_single_runs(tree, tmp_path):
    """run_edit_batch over two samples gives what two single runs on one
    pipeline give: xt and strips within the CPU convolution's
    batch-size-dependent summation order (the tolerances of
    test_cli_edit_matches_jax, relative to the largest value), the same
    bases, the same artifacts."""
    _, _, tm = tiny_pair()
    den = Denoiser(eps_fn=lambda z, t: tm(z, t), sample_shape=(32, 32, 3),
                   device=torch.device("cpu"))
    ds = CelebAMaskDataset(tree, image_size=32)
    x0s = np.concatenate([ds[0], ds[1]])
    masks = np.concatenate([ds.getmask(0, "hair"), ds.getmask(1, "skin")])
    settings = dict(for_steps=6, inv_steps=6, x_space_guidance_num_step=2, vis_num=1,
                    vis_num_pc=2, pca_rank=2, pca_rank_null=2, min_iter=2, max_iter=3)

    def pipe(sub):
        cfg = UncondEditConfig(result_folder=str(tmp_path / sub), **settings)
        return UncondEditPipeline(den, cfg, JaxDraws(jax.random.key(3)), device="cpu")

    batch = pipe("batch").run_edit_batch(x0s=x0s, masks=masks, sample_names=["a", "b"])
    single_pipe = pipe("single")
    singles = [single_pipe.run_edit_null_space_projection(
        x0=x0s[i:i + 1], mask=masks[i:i + 1], sample_name=n)
        for i, n in enumerate(["a", "b"])]
    for got, ref in zip(batch, singles):
        np.testing.assert_allclose(got["xt"], ref["xt"],
                                   atol=2e-5 * np.abs(ref["xt"]).max())
        cos = np.linalg.svd(got["vT"] @ ref["vT"].T, compute_uv=False)
        assert cos.min() > 0.9999, cos
        for pc in ref["strips"]:
            np.testing.assert_allclose(got["strips"][pc], ref["strips"][pc],
                                       atol=5e-5 * np.abs(ref["strips"][pc]).max())
    assert _tree_files(str(tmp_path / "batch")) == _tree_files(str(tmp_path / "single"))
    with pytest.raises(ValueError, match="one mask per sample"):
        pipe("c").run_edit_batch(x0s=x0s, masks=masks[:1])

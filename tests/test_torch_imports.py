"""loco_edit_tpu_torch stands alone: no module imports JAX, Flax or the JAX
package, it imports with JAX made unimportable, and its entry points refuse
to run on the CPU unless asked."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "loco_edit_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "loco_edit_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _modules():
    return sorted(
        os.path.relpath(f, ROOT)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for f in _port_files() if f.startswith(PKG))


def test_no_jax_imports_ast():
    """Top-level names match exactly: loco_edit_tpu_torch itself starts with
    "loco_edit_tpu" and is allowed."""
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert len(_port_files()) > 20


def test_imports_with_jax_unimportable():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'loco_edit_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from loco_edit_tpu_torch.core.rng import RngStream
    from loco_edit_tpu_torch.models.registry import load_adm_denoiser, load_tiny_denoiser
    from loco_edit_tpu_torch.pipelines import UncondEditConfig, UncondEditPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_adm_denoiser("FFHQ_P2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_tiny_denoiser()
    den = load_tiny_denoiser(device="cpu")
    cfg = UncondEditConfig(result_folder=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UncondEditPipeline(den, cfg, RngStream.from_seed(0))
    pipe = UncondEditPipeline(den, cfg, RngStream.from_seed(0), device="cpu")
    assert pipe.device == torch.device("cpu")


def test_cli_and_ddpm_loader_raise_without_a_card(monkeypatch, tmp_path):
    """The CLI with no --device runs on the card, so without one it raises
    before it loads anything; --device cpu runs."""
    from loco_edit_tpu_torch.cli.main import main
    from loco_edit_tpu_torch.models.ddpm import load_ddpm_denoiser

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--model_name", "TinyTest", "--dataset_name", "Random", "--use_mask",
            "false", "--run_ddim_forward", "true", "--for_steps", "2", "--seed", "1",
            "--result_folder", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_ddpm_denoiser("CelebA_HQ_HF")
    out = main(argv + ["--device", "cpu"])
    assert out["forward"].shape == (5, 32, 32, 3) and np.isfinite(out["forward"]).all()


def test_kernel_wrappers_refuse_cpu_tensors():
    from loco_edit_tpu_torch.ops.flash_attention import AttentionFn, flash_attention_cuda
    from loco_edit_tpu_torch.ops.groupnorm import group_norm_cuda

    x = torch.zeros(1, 32, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        group_norm_cuda(x, torch.ones(32), torch.zeros(32))
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel"):
        AttentionFn.apply(*(torch.zeros(1, 1, 4, 16, device="meta"),) * 3)
    assert group_norm_cuda.launches == 0 and flash_attention_cuda.launches == 0


def test_tiny_cpu_flagship_runs(tmp_path):
    """The port's own flagship on the tiny model and the CPU, with its own
    torch random streams: finite unit-norm directions, finite strips."""
    from loco_edit_tpu_torch.core.rng import seed_everything
    from loco_edit_tpu_torch.models.registry import load_tiny_denoiser
    from loco_edit_tpu_torch.pipelines import UncondEditConfig, UncondEditPipeline

    torch.set_num_threads(2)
    cfg = UncondEditConfig(for_steps=6, inv_steps=6, x_space_guidance_num_step=2,
                           vis_num=2, vis_num_pc=1, pca_rank=2, pca_rank_null=2,
                           min_iter=1, max_iter=2, result_folder=str(tmp_path),
                           save_images=False)
    pipe = UncondEditPipeline(load_tiny_denoiser(device="cpu"), cfg,
                              seed_everything(3), device="cpu")
    x0 = np.random.default_rng(0).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    mask = np.zeros_like(x0, bool)
    mask[:, 10:22, 10:22] = True
    out = pipe.run_edit_null_space_projection(x0=x0, mask=mask)
    np.testing.assert_allclose(np.linalg.norm(out["vT"], axis=1), 1.0, rtol=1e-5)
    assert out["strips"][0].shape == (5, 32, 32, 3)   # frames 0, 1, 2 each side
    assert np.isfinite(out["strips"][0]).all()


def test_sd_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The SD bundle, the SD pipeline and the SD CLI run on the card unless
    asked for the CPU; without one they raise before building anything."""
    import argparse

    from loco_edit_tpu_torch.cli.main import main
    from loco_edit_tpu_torch.core.rng import RngStream
    from loco_edit_tpu_torch.models.t2i_registry import load_sd_bundle
    from loco_edit_tpu_torch.pipelines.sd import SDEditConfig, SDEditPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(dtype="fp32", checkpoint_path="", vae_path="",
                              text_encoder_path="", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_sd_bundle(args)
    f = lambda *a: None   # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDEditPipeline(f, f, f, f, SDEditConfig(result_folder=str(tmp_path)),
                       RngStream.from_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model_name", "stabilityai/stable-diffusion-2-1-base",
              "--performance_boosting_t", "0", "--use_mask", "false",
              "--run_ddim_forward", "true", "--result_folder", str(tmp_path)])

"""One-command edit-quality parity harness (port of
loco_edit_tpu/cli/parity_eval.py, BASELINE.md protocol 3).

Given a real CelebA-HQ checkpoint, reproduces the canonical configs
(reference README.md: idx 3456 hair / 4729 l_eye, rank-5 basis @0.6T,
null-space rank 5, scale 0.5 x 16 steps) and reports, per sample:

  - ssim            edited endpoint vs original (structural preservation)
  - offmask_mse     MSE OUTSIDE the edit mask (edit locality: the paper's
                    claim; lower is better)
  - inmask_mse      MSE inside the mask (the edit actually did something)
  - ssim_vs_ref / lpips_vs_ref  when --reference_dir points at the PyTorch
                    reference's PNGs for the same configs

Runs on the card unless `--device cpu`:
  python -m loco_edit_tpu_torch.cli.parity_eval \
      --model_name CelebA_HQ_HF --checkpoint_path celeba_hq.pt \
      --dataset_root $CELEBA_MASK_ROOT [--reference_dir runs_ref]

A tiny-model dry run (TinyTest, --dataset_name Random, a box mask) runs on
the CPU in tests/test_torch_logger.py.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser("loco-edit-tpu parity_eval")
    p.add_argument("--model_name", type=str, default="CelebA_HQ_HF")
    p.add_argument("--dataset_name", type=str, default="CelebA_HQ_mask")
    p.add_argument("--checkpoint_path", type=str, default="")
    p.add_argument("--dataset_root", type=str, default="")
    p.add_argument("--sample_specs", type=str, default="3456:hair,4729:l_eye",
                   help="comma list of sample_idx:semantic")
    p.add_argument("--reference_dir", type=str, default="",
                   help="folder of reference PNGs named <idx>_<sem>.png")
    p.add_argument("--result_folder", type=str, default="./runs/parity")
    p.add_argument("--edit_t", type=float, default=0.6)
    p.add_argument("--pca_rank", type=int, default=5)
    p.add_argument("--pca_rank_null", type=int, default=5)
    p.add_argument("--for_steps", type=int, default=100)
    p.add_argument("--x_space_guidance_scale", type=float, default=0.5)
    p.add_argument("--x_space_guidance_num_step", type=int, default=16)
    p.add_argument("--performance_boosting_t", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card, the default) | cpu")
    return p.parse_args(argv)


def _metrics(edited: np.ndarray, original: np.ndarray, mask: np.ndarray | None,
             device) -> dict:
    from loco_edit_tpu_torch.utils import metrics

    out = {"ssim": float(metrics.ssim(edited, original, data_range=2.0,
                                      device=device)[0])}
    if mask is not None:
        m = np.asarray(mask, bool)
        out["offmask_mse"] = float(metrics.masked_mse(edited, original, ~m,
                                                      device=device)[0])
        out["inmask_mse"] = float(metrics.masked_mse(edited, original, m,
                                                     device=device)[0])
    return out


def run_one(pa, idx: int, sem: str) -> dict:
    """Edit one canonical sample and measure locality; returns a metric dict."""
    from loco_edit_tpu_torch.cli.args import parse_args as cli_parse
    from loco_edit_tpu_torch.cli.args import preset
    from loco_edit_tpu_torch.cli.main import build_uncond_pipeline, get_sample_and_mask

    argv = [
        "--model_name", pa.model_name, "--dataset_name", pa.dataset_name,
        "--checkpoint_path", pa.checkpoint_path,
        "--dataset_root", pa.dataset_root,
        "--sample_idx", str(idx), "--choose_sem", sem,
        "--for_steps", str(pa.for_steps), "--inv_steps", str(pa.for_steps),
        "--edit_t", str(pa.edit_t),
        "--performance_boosting_t", str(pa.performance_boosting_t),
        "--x_space_guidance_scale", str(pa.x_space_guidance_scale),
        "--x_space_guidance_num_step", str(pa.x_space_guidance_num_step),
        "--pca_rank", str(pa.pca_rank), "--pca_rank_null", str(pa.pca_rank_null),
        "--run_edit_null_space_projection", "true",
        "--null_space_projection", "true", "--use_mask", "true",
        "--result_folder", pa.result_folder, "--seed", str(pa.seed),
        "--vis_num", "2", "--device", pa.device,
    ]
    args = preset(cli_parse(argv))
    pipe, denoiser, rng = build_uncond_pipeline(args)

    if pa.dataset_name == "Random":  # dry-run path: generated image + box mask
        h, w, c = denoiser.sample_shape
        xT = rng.fork("xT").normal((1, h, w, c), device=pipe.device)
        x0 = pipe.generate(xT, 0, None).cpu().numpy()
        mask = np.zeros((1, h, w, c), bool)
        mask[:, h // 4: h // 2, w // 4: w // 2, :] = True
    else:
        x0, _, mask = get_sample_and_mask(args, pipe, denoiser, rng)

    out = pipe.run_edit_null_space_projection(
        x0=x0, mask=mask, sample_name=f"parity_idx{idx}_{sem}")
    # the strip's last frame is the strongest + direction edit
    edited = np.asarray(out["strips"][0][-1:], np.float32)
    rec = {"sample_idx": idx, "semantic": sem,
           **_metrics(edited, np.asarray(x0), mask, pipe.device)}

    if pa.reference_dir:
        from PIL import Image

        ref_path = os.path.join(pa.reference_dir, f"{idx}_{sem}.png")
        if os.path.exists(ref_path):
            from loco_edit_tpu_torch.utils import metrics

            ref = np.asarray(Image.open(ref_path).convert("RGB"),
                             np.float32)[None] / 127.5 - 1.0
            rec["ssim_vs_ref"] = float(
                metrics.ssim(edited, ref, data_range=2.0, device=pipe.device)[0])
            try:
                rec["lpips_vs_ref"] = float(metrics.lpips(
                    (edited + 1) / 2, (ref + 1) / 2, device=pipe.device)[0])
            except Exception as e:  # LPIPS weights are gated (no egress)
                rec["lpips_vs_ref_error"] = str(e)
        else:
            rec["ref_missing"] = ref_path
    return rec


def main(argv=None):
    pa = parse_args(argv)
    os.makedirs(pa.result_folder, exist_ok=True)
    records = []
    for spec in pa.sample_specs.split(","):
        idx, sem = spec.split(":")
        rec = run_one(pa, int(idx), sem)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    with open(os.path.join(pa.result_folder, "parity_metrics.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return records


if __name__ == "__main__":
    main()

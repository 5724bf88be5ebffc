"""Paired-folder evaluation CLI (port of loco_edit_tpu/cli/eval.py): the
reference's src/eval.py with its defects fixed (there eval_LPIPS calls
ssim, folder paths are hardcoded empty, and the mmse branch references
undefined names). Runs on the card unless `--device cpu`.

  python -m loco_edit_tpu_torch.cli.eval --eval_metric ssim \
      --folder_preds runs/edits --folder_original runs/originals \
      [--mask_folder runs/masks]   # masked MSE (edit locality)
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np
from PIL import Image


def parse_args(argv=None):
    p = argparse.ArgumentParser("loco-edit-tpu eval")
    p.add_argument("--eval_metric", type=str, default="ssim",
                   choices=["ssim", "lpips", "mmse"])
    p.add_argument("--folder_preds", type=str, required=True)
    p.add_argument("--folder_original", type=str, required=True)
    p.add_argument("--mask_folder", type=str, default="",
                   help="npz/png masks per pair (mmse only); empty = full-image MSE")
    p.add_argument("--data_range", type=float, default=255.0)
    p.add_argument("--lpips_weights", type=str, default="",
                   help="local torch LPIPS checkpoint ('full.pth' or "
                        "'backbone.pth:lins.pth'); empty = LOCO_LPIPS_WEIGHTS "
                        "env, then torchmetrics")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card, the default) | cpu")
    return p.parse_args(argv)


def _load(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.float32)[None]


def _load_mask(folder: str, stem: str, shape) -> np.ndarray | None:
    for ext, loader in ((".npz", lambda p: np.load(p)["masks"]),
                        (".npy", np.load),
                        (".png", lambda p: np.asarray(Image.open(p)) > 127)):
        p = os.path.join(folder, stem + ext)
        if os.path.exists(p):
            m = np.asarray(loader(p), bool)
            while m.ndim < 4:
                m = m[None] if m.ndim != 3 or m.shape[-1] in (1, 3) else m[..., None]
            return m
    return None


def main(argv=None):
    from loco_edit_tpu_torch.core.device import resolve_device
    from loco_edit_tpu_torch.utils import metrics

    args = parse_args(argv)
    device = resolve_device(args.device)
    preds = sorted(glob(os.path.join(args.folder_preds, "*.png")))
    targets = sorted(glob(os.path.join(args.folder_original, "*.png")))
    if len(preds) != len(targets):
        raise SystemExit(f"pair count mismatch: {len(preds)} vs {len(targets)}")

    results = []
    for pp, tp in zip(preds, targets):
        if os.path.basename(pp) != os.path.basename(tp):
            raise SystemExit(f"pairs not matched: {pp} vs {tp}")
        a, b = _load(pp), _load(tp)
        if a.shape != b.shape:
            raise SystemExit(f"shape mismatch for {pp}: {a.shape} vs {b.shape}")
        if args.eval_metric == "ssim":
            r = float(metrics.ssim(a, b, data_range=args.data_range, device=device)[0])
        elif args.eval_metric == "lpips":
            r = float(metrics.lpips(a / args.data_range, b / args.data_range,
                                    weights_path=args.lpips_weights or None,
                                    device=device)[0])
        else:
            stem = os.path.splitext(os.path.basename(pp))[0]
            mask = (_load_mask(args.mask_folder, stem, a.shape)
                    if args.mask_folder else None)
            r = float(metrics.masked_mse(a, b, mask, device=device)[0])
        results.append(r)

    print(f"{args.eval_metric} over {len(results)} pairs: "
          f"{float(np.mean(results)):.6f}")
    return float(np.mean(results))


if __name__ == "__main__":
    main()

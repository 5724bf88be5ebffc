"""CelebAMask-HQ ground-truth mask dataset (port of
loco_edit_tpu/masks/celeba.py).

Parses the CelebA-HQ-img / CelebAMask-HQ-mask-anno tree and serves images
(NHWC in [-1,1]) plus per-semantic boolean masks, mirroring the reference's
CelebAMaskDataLoader (src/dataset/celeba_hq_dataloader.py:9-123): 19 facial
semantics, annotation files named {idx:05d}_{sem}.png in numbered subdirs,
masks resized to model resolution.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from loco_edit_tpu_torch.data.datasets import pil_to_array

CELEBA_SEMANTICS = (
    "background", "skin", "nose", "eye_g", "l_eye", "r_eye", "l_brow",
    "r_brow", "l_ear", "r_ear", "mouth", "u_lip", "l_lip", "hair", "hat",
    "ear_r", "neck_l", "neck", "cloth",
)


class CelebAMaskDataset:
    def __init__(self, root: str, image_size: int = 256,
                 save_path: str | None = None):
        self.root = root
        self.image_size = image_size
        self.save_path = save_path
        if save_path:
            os.makedirs(save_path, exist_ok=True)
        self.index = self._parse()

    def _parse(self) -> dict[int, dict]:
        img_dir = os.path.join(self.root, "CelebA-HQ-img")
        anno_dir = os.path.join(self.root, "CelebAMask-HQ-mask-anno")
        index: dict[int, dict] = {}
        for f in sorted(os.listdir(img_dir)):
            stem = f.split(".")[0]
            if stem.isdigit():
                index[int(stem)] = {
                    "image_path": os.path.join(img_dir, f),
                    "annotation_paths": [],
                }
        for sub in sorted(os.listdir(anno_dir)):
            subp = os.path.join(anno_dir, sub)
            if not (sub.isdigit() and os.path.isdir(subp)):
                continue
            for f in sorted(os.listdir(subp)):
                if f[:5].isdigit() and int(f[:5]) in index:
                    index[int(f[:5])]["annotation_paths"].append(
                        os.path.join(subp, f))
        return index

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> np.ndarray:
        img = Image.open(self.index[idx]["image_path"])
        x = pil_to_array(img, self.image_size)
        if self.save_path:
            img.convert("RGB").resize((self.image_size, self.image_size)).save(
                os.path.join(self.save_path, f"image_{idx}.png"))
        return x

    def available_semantics(self, idx: int) -> list[str]:
        sems = []
        for p in self.index[idx]["annotation_paths"]:
            sem = os.path.basename(p)[6:].split(".")[0]
            if sem in CELEBA_SEMANTICS:
                sems.append(sem)
        return sems

    def getmask(self, idx: int, choose_sem: str) -> np.ndarray:
        """Boolean mask (1, H, W, 3) for a semantic of sample idx (the
        reference returns (3,H,W); we are NHWC)."""
        sems = self.available_semantics(idx)
        if choose_sem not in sems:
            raise ValueError(
                f"semantic {choose_sem!r} not annotated for sample {idx}; "
                f"available: {sems}")
        for p in self.index[idx]["annotation_paths"]:
            if os.path.basename(p)[6:].split(".")[0] == choose_sem:
                m = Image.open(p).resize((self.image_size, self.image_size))
                mask = np.asarray(m).astype(bool)
                if mask.ndim == 2:
                    mask = mask[..., None].repeat(3, axis=-1)
                return mask[None]
        raise AssertionError("unreachable")

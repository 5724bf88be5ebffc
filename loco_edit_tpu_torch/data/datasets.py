"""Datasets: images as NHWC float32 numpy arrays in [-1, 1] (port of
loco_edit_tpu/data/datasets.py).

Folder datasets (FFHQ/CelebA/AFHQ-style trees), HF-hub datasets (LSUN
church/bedroom, Metfaces, Flowers-102; these need the `datasets` package and
its cache), CelebAMask-HQ (masks/celeba.py), and 'Random' (seeded noise, no
dataset). Pure PIL/numpy: the pipeline moves the arrays to its device.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
from PIL import Image

_EXTS = (".png", ".jpg", ".jpeg", ".webp")


def pil_to_array(img: Image.Image, image_size: int) -> np.ndarray:
    """Resize -> float32 NHWC in [-1, 1], batch dim 1."""
    img = img.convert("RGB").resize((image_size, image_size))
    x = np.asarray(img, dtype=np.float32) / 255.0
    return (x * 2.0 - 1.0)[None]


class ImageFolderDataset:
    """Sorted image tree (reference ImgDataset, utils.py:589-630; AFHQ variant
    :631-673 walks nested class dirs — we glob recursively to cover both)."""

    def __init__(self, image_root: str, image_size: int = 256):
        self.image_size = image_size
        files: list[str] = []
        for ext in _EXTS:
            files += glob(os.path.join(image_root, f"**/*{ext}"), recursive=True)
        self.files = sorted(files)
        if not self.files:
            raise FileNotFoundError(f"no images under {image_root}")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        return pil_to_array(Image.open(self.files[idx]), self.image_size)


class HFImageDataset:
    """HF-hub dataset wrapper (reference HFDataset, utils.py:549-588)."""

    DATASET_IDS = {
        "LSUN_church": "tglcourse/lsun_church_train",
        "LSUN_bedroom": "pcuenq/lsun-bedrooms",
        "Metface": "huggan/metfaces",
        "Flower": "huggan/flowers-102-categories",
    }

    def __init__(self, dataset_name: str, image_size: int = 256,
                 dataset_id: str | None = None, split: str = "train"):
        from datasets import load_dataset  # gated: needs network on first use

        self.image_size = image_size
        dataset_id = dataset_id or self.DATASET_IDS[dataset_name]
        self.dataset = load_dataset(dataset_id, split=split)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> np.ndarray:
        return pil_to_array(self.dataset[idx]["image"], self.image_size)


def get_dataset(dataset_name: str, dataset_root: str = "", image_size: int = 256,
                save_path: str | None = None):
    """Dispatch by the reference's dataset names (utils.py:472-546).
    'Random' returns None (seeded-noise workflows)."""
    if dataset_name == "Random":
        return None
    if dataset_name == "CelebA_HQ_mask":
        from loco_edit_tpu_torch.masks.celeba import CelebAMaskDataset

        return CelebAMaskDataset(dataset_root, image_size=image_size,
                                 save_path=save_path)
    if dataset_name in HFImageDataset.DATASET_IDS:
        return HFImageDataset(dataset_name, image_size)
    if dataset_name in ("FFHQ", "AFHQ", "CelebA_HQ", "Examples"):
        return ImageFolderDataset(dataset_root, image_size)
    raise ValueError(f"unknown dataset {dataset_name!r}")

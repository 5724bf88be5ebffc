"""Sharded training data loading (port of loco_edit_tpu/training/data.py).

The reference's MPI-sharded image loader (guided_diffusion/
image_datasets.py:11-123: rank/size sharding :83-99, class labels from
filename prefixes :60-71, the crop pipeline :126-165). Sharding is by the
torch.distributed rank when a process group is initialized, else one shard.
Images are decoded on the host by the native pipeline (native/), or by PIL
where that library cannot build; batches come out as NHWC f32 tensors in
[-1, 1] on `device`.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch
from PIL import Image

from loco_edit_tpu_torch.core.device import resolve_device
from loco_edit_tpu_torch.data.datasets import _EXTS


def list_image_files_recursively(data_dir: str) -> list[str]:
    out: list[str] = []
    for root, _, files in sorted(os.walk(data_dir)):
        for f in sorted(files):
            if f.lower().endswith(_EXTS):
                out.append(os.path.join(root, f))
    return out


def _center_crop_resize(img: Image.Image, size: int) -> np.ndarray:
    """The reference's crop pipeline: downsample by halves, then resize the
    short side to `size` and center-crop (image_datasets.py:126-146)."""
    while min(img.size) >= 2 * size:
        img = img.resize((img.size[0] // 2, img.size[1] // 2), Image.BOX)
    scale = size / min(img.size)
    img = img.resize((round(img.size[0] * scale), round(img.size[1] * scale)),
                     Image.BICUBIC)
    arr = np.asarray(img.convert("RGB"), np.float32)
    ch, cw = (arr.shape[0] - size) // 2, (arr.shape[1] - size) // 2
    arr = arr[ch:ch + size, cw:cw + size]
    return arr / 127.5 - 1.0


def _rank_and_size() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedImageLoader:
    """Infinite epoch iterator over an image tree, sharded across ranks,
    yielding (images (B, S, S, 3) f32 on `device`, labels (B,) or None).

    class_cond: integer labels from the filename prefix before the first
    '_' (the reference's convention, image_datasets.py:60-67). `decoder` is
    "native" or "pil": the one that runs.
    """

    def __init__(self, data_dir: str, batch_size: int, image_size: int = 256,
                 class_cond: bool = False, seed: int = 0,
                 process_index: int | None = None,
                 process_count: int | None = None,
                 use_native: bool = True,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.files = list_image_files_recursively(data_dir)
        if not self.files:
            raise FileNotFoundError(f"no images under {data_dir}")
        self.batch_size = batch_size
        self.image_size = image_size
        self.rng = np.random.default_rng(seed)
        rank, world = _rank_and_size()
        pi = rank if process_index is None else process_index
        pc = world if process_count is None else process_count
        self.files = self.files[pi::pc]
        self._native = None
        if use_native:
            from loco_edit_tpu_torch import native

            if native.available():
                self._native = native
        self.decoder = "native" if self._native is not None else "pil"
        self.labels = None
        if class_cond:
            names = [os.path.basename(p).split("_")[0] for p in self.files]
            lut = {c: i for i, c in enumerate(sorted(set(names)))}
            self.labels = np.asarray([lut[n] for n in names], np.int64)

    def _decode(self, idx) -> np.ndarray:
        if self._native is not None:
            try:
                return self._native.load_batch([self.files[i] for i in idx],
                                               self.image_size)
            except IOError:
                pass
        return np.stack([_center_crop_resize(Image.open(self.files[i]), self.image_size)
                         for i in idx])

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor | None]]:
        n = len(self.files)
        while True:
            order = self.rng.permutation(n)
            for s in range(0, n - self.batch_size + 1, self.batch_size):
                idx = order[s:s + self.batch_size]
                imgs = torch.from_numpy(self._decode(idx)).to(self.device)
                labels = (None if self.labels is None
                          else torch.from_numpy(self.labels[idx]).to(self.device))
                yield imgs, labels

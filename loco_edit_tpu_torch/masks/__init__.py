from loco_edit_tpu_torch.masks.celeba import CelebAMaskDataset, CELEBA_SEMANTICS

__all__ = ["CelebAMaskDataset", "CELEBA_SEMANTICS"]

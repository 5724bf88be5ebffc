from loco_edit_tpu_torch.masks.celeba import CelebAMaskDataset, CELEBA_SEMANTICS
from loco_edit_tpu_torch.masks.diffedit import diffedit_mask

__all__ = ["CelebAMaskDataset", "CELEBA_SEMANTICS", "diffedit_mask"]

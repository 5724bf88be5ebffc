from loco_edit_tpu_torch.masks.celeba import CelebAMaskDataset, CELEBA_SEMANTICS
from loco_edit_tpu_torch.masks.diffedit import diffedit_mask
from loco_edit_tpu_torch.masks.sam import (SamBundle, extract_and_cache_masks, prepare_sam,
                                           sam_preset, segment_image,
                                           segment_image_on_device)
from loco_edit_tpu_torch.masks.sam_decoder import SamDecoderConfig, SamMaskDecodeModel
from loco_edit_tpu_torch.masks.sam_vit import SamViTConfig, SamViTEncoder

__all__ = ["CelebAMaskDataset", "CELEBA_SEMANTICS", "diffedit_mask", "SamBundle",
           "SamDecoderConfig", "SamMaskDecodeModel", "SamViTConfig", "SamViTEncoder",
           "extract_and_cache_masks", "prepare_sam", "sam_preset", "segment_image",
           "segment_image_on_device"]

from loco_edit_tpu_torch.data.datasets import (
    ImageFolderDataset,
    HFImageDataset,
    get_dataset,
)

__all__ = ["ImageFolderDataset", "HFImageDataset", "get_dataset"]

from loco_edit_tpu_torch.models.ifm.convert import (convert_if_state_dict,
                                                    if_params_from_flax, infer_if_config)
from loco_edit_tpu_torch.models.ifm.presets import if_preset, tiny_if_config
from loco_edit_tpu_torch.models.ifm.unet import (IFAttention, IFResBlock, IFUNet,
                                                 IFUNetConfig, TextTimeEmbedding)

__all__ = ["IFUNet", "IFUNetConfig", "IFAttention", "IFResBlock", "TextTimeEmbedding",
           "if_preset", "tiny_if_config", "convert_if_state_dict", "infer_if_config",
           "if_params_from_flax"]

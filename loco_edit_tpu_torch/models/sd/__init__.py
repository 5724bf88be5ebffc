from loco_edit_tpu_torch.models.sd.config import SDUNetConfig, VAEConfig, sd_preset
from loco_edit_tpu_torch.models.sd.unet import SDUNet
from loco_edit_tpu_torch.models.sd.vae import VAEDecoder, VAEEncoder, encode_sample

__all__ = ["SDUNetConfig", "VAEConfig", "sd_preset", "SDUNet",
           "VAEDecoder", "VAEEncoder", "encode_sample"]

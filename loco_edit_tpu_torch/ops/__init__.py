from loco_edit_tpu_torch.ops.attention import sdp_attention
from loco_edit_tpu_torch.ops.conv import Conv2d, conv2d
from loco_edit_tpu_torch.ops.norms import group_norm_f32

__all__ = ["sdp_attention", "group_norm_f32", "Conv2d", "conv2d"]

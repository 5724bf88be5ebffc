"""x-space guidance: straight-line walks along edit directions (port of
loco_edit_tpu/editing/walk.py).

Frames xt + k*scale*step*v_k for both +/- directions, subsampled to
`vis_num`, concatenated as the mirrored strip [flip(neg)[:-1], pos].
"""

from __future__ import annotations

import numpy as np
import torch

from loco_edit_tpu_torch.core.device import to_device


def _subsample_indices(length: int, vis_num: int) -> np.ndarray:
    """[0, -1] when vis_num == 1, else a stride slice [::len // vis_num]."""
    if vis_num == 1:
        return np.array([0, length - 1])
    stride = max(length // vis_num, 1)
    return np.arange(0, length, stride)


def x_space_guidance_strip(xt: torch.Tensor, vk: torch.Tensor, *,
                           scale: float, edit_step: float, num_steps: int,
                           vis_num: int) -> torch.Tensor:
    """Build the mirrored edit strip around xt (shape (1, ...)) along vk.

    Returns (n_frames, *xt.shape[1:]) with the negative side flipped in front
    and its duplicate center frame dropped.
    """
    vk = vk.reshape(xt.shape[1:]).to(xt.dtype)
    ks = (torch.arange(0, num_steps + 1, dtype=xt.dtype, device=xt.device)
          * (scale * edit_step))
    idx = to_device(_subsample_indices(num_steps + 1, vis_num), xt.device, torch.long)
    pos = (xt + ks[:, None, None, None] * vk[None])[idx]
    neg = (xt - ks[:, None, None, None] * vk[None])[idx]
    return torch.cat([neg.flip(0)[:-1], pos], dim=0)

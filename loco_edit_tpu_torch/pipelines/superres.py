"""The IF stage-2 super-resolution sampler (port of
loco_edit_tpu/pipelines/superres.py).

Stage 2 is a sampler over an IF-architecture U-Net whose input is [x_t |
the upsampled stage-1 image] on channels (the cascade conditioning),
denoised on the linspace DDIM grid with CFG under the 'for' prompt. With
`aug_level` set (the IF-II protocol, diffusers' noise_level 250), the
conditioning image is noise-augmented at that raw timestep and the level is
fed to the U-Net's class embedding: unet_apply(x, t, ctx, aug_t). Returns
images in [-1, 1]. Every U-Net call (one a step: the CFG variants ride on
the batch) adds one to the request's `sr_forwards` counter
(utils/logger.py::count).
"""

from __future__ import annotations

import numpy as np
import torch

from loco_edit_tpu_torch.core.rng import RngStream
from loco_edit_tpu_torch.diffusion import LinspaceDDIM
from loco_edit_tpu_torch.diffusion.sampling import ddim_scan
from loco_edit_tpu_torch.editing.cfg import cfg_eps
from loco_edit_tpu_torch.utils.logger import count


def _bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NHWC x with align_corners=True (output corners
    sample input corners; src = dst * (in - 1) / (out - 1)), the diffusers
    IF-II preprocessing, with the JAX package's weights (f64 source
    positions, f32 weights)."""

    def axis_weights(n_in: int, n_out: int):
        if n_in == 1 or n_out == 1:
            return np.zeros(n_out, np.int64), np.zeros(n_out, np.float32)
        src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
        i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
        return i0, (src - i0).astype(np.float32)

    _, h, w, _ = x.shape
    x = x.float()
    dev = x.device
    iy, wy = axis_weights(h, out_h)
    ix, wx = axis_weights(w, out_w)
    wy = torch.from_numpy(wy).to(dev)[None, :, None, None]
    wx = torch.from_numpy(wx).to(dev)[None, None, :, None]
    idx = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    rows = (x.index_select(1, idx(iy)) * (1 - wy)
            + x.index_select(1, idx(np.minimum(iy + 1, h - 1))) * wy)
    return (rows.index_select(2, idx(ix)) * (1 - wx)
            + rows.index_select(2, idx(np.minimum(ix + 1, w - 1))) * wx)


class SuperResSampler:
    """unet_apply(x_2c, t, ctx[, aug_t]) -> (B, H, W, 2C) learned-sigma
    output, x_2c = [noisy target | conditioning image] on channels. Plug an
    instance into IFEditPipeline(superres=...)."""

    def __init__(self, unet_apply, prompt_encoder, *, out_size: int = 256,
                 channels: int = 3, steps: int = 50, guidance_scale: float = 4.0,
                 t_max: int = 990, aug_level: int | None = None,
                 noise_schedule: str = "squaredcos_cap_v2",
                 rng: RngStream | None = None, device: str | torch.device = "cuda"):
        self.out_size = out_size
        self.c = channels
        self.guidance_scale = guidance_scale
        self.prompt_encoder = prompt_encoder
        self.device = torch.device(device)
        # IF-II checkpoints (and their image-noising scheduler) are trained
        # on the squaredcos_cap_v2 cosine table: the DDIM alpha-bars and the
        # aug-level noising both use it
        self.scheduler = LinspaceDDIM(t_max=t_max, noise_schedule=noise_schedule)
        self.grid = self.scheduler.generation_grid(steps)
        self.aug_level = aug_level
        self.rng = rng or RngStream.from_seed(0)
        if aug_level is None:
            self.unet_apply = lambda x, t, ctx: unet_apply(x, t, ctx)[..., :channels]
        else:
            self.unet_apply = lambda x, t, ctx: unet_apply(
                x, t, ctx, float(aug_level))[..., :channels]
        self._emb_cache: dict = {}
        self._calls = 0   # a fresh noise stream per call

    def _emb(self, prompt: str) -> torch.Tensor:
        if prompt not in self._emb_cache:
            self._emb_cache[prompt] = self.prompt_encoder(prompt).to(
                self.device, torch.float32)
        return self._emb_cache[prompt]

    @torch.no_grad()
    def __call__(self, low_res, prompt: str) -> torch.Tensor:
        """low_res: (B, h, w, C) in [-1, 1] -> (B, out_size, out_size, C)."""
        low = torch.as_tensor(low_res).to(self.device, torch.float32)
        b = low.shape[0]
        prompts = {"for": self._emb(prompt), "edit": self._emb(""), "null": self._emb("")}
        cond = _bilinear_align_corners(low, self.out_size, self.out_size)
        call = self._calls
        self._calls += 1
        if self.aug_level is not None:
            # noise-augment the conditioning image at the aug level
            ab = np.float32(self.scheduler.schedule.alphas_cumprod[self.aug_level])
            noise = self.rng.fork("sr-aug").at_step(call).normal(
                cond.shape, device=self.device)
            cond = float(np.sqrt(ab)) * cond + float(np.sqrt(np.float32(1.0) - ab)) * noise

        def unet_with_cond(x, t, ctx):
            # cfg_eps stacks the CFG variants on the batch axis; the
            # conditioning image is repeated to match
            cc = torch.cat([cond] * (x.shape[0] // cond.shape[0]), dim=0).to(x.dtype)
            count("sr_forwards")
            return self.unet_apply(torch.cat([x, cc], dim=-1), t, ctx)

        def eps(x, t):
            return cfg_eps(unet_with_cond, x, t, prompts, "null+(for-null)",
                           self.guidance_scale, enabled=self.guidance_scale > 1.0)

        xT = self.rng.fork("sr-noise").at_step(call).normal(
            (b, self.out_size, self.out_size, self.c), device=self.device)
        return torch.clamp(ddim_scan(eps, xT, self.grid), -1.0, 1.0)

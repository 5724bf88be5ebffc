"""T-LOCO on a Latent Consistency Model: few-step z-space editing (port of
loco_edit_tpu/pipelines/lcm.py).

4-step LCM sampling with the guidance-scale embedding (w = guidance_scale -
1, no CFG batch), the edit at an integer step index (default 2),
text-supervised prompt-delta directions or the unsupervised subspace
iteration on the consistency output through the VAE decoder, null-space
projection, walks, and the SEGA ablation (denoise the tail under the edit
prompt). Fresh modify + null bases fuse into one dual iteration on the
shared Jacobian (the non-semantic path); the strip is denoised as one frame
batch, chunked by cfg.memory_bound, and decoded in one batch.

Randomness comes from named forks of the run's RngStream with the JAX
package's stream names ("zT", "lcm-noise", "lcm-probes-{rank}"), so a test
can hand the pipeline a stream that yields the JAX package's draws; the
`noise_fn` hook overrides the inter-step noise alone. With
`cfg.pixel_output` the decoded strip is converted to uint8 pixels on the
device before the copy to the host. The mesh knobs
(--mesh_probe, --mesh_data) come from EngineExec (pipelines/common.py).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from loco_edit_tpu_torch.core.device import resolve_device
from loco_edit_tpu_torch.core.mesh import is_main_process
from loco_edit_tpu_torch.core.rng import RngStream
from loco_edit_tpu_torch.diffusion.lcm import LCMGrid, lcm_denoised, lcm_grid, lcm_scan
from loco_edit_tpu_torch.editing import (
    dual_subspace_iteration,
    load_directions,
    normalize_rows,
    null_space_project,
    save_directions,
    subspace_iteration,
    x_space_guidance_strip,
)
from loco_edit_tpu_torch.editing.pullback import padded_probe_count
from loco_edit_tpu_torch.pipelines.common import EngineExec, _host, _Phase
from loco_edit_tpu_torch.utils.io import save_image_grid, to_uint8_pixels_device


@dataclasses.dataclass
class LCMEditConfig:
    num_inference_steps: int = 4
    edit_t_idx: int = 2
    guidance_scale: float = 7.5
    x_space_guidance_scale: float = 5.0
    x_space_guidance_edit_step: float = 1.0
    x_space_guidance_num_step: int = 1
    vis_num: int = 1
    pca_rank: int = 1
    pca_rank_null: int = 5
    null_space_projection: bool = True
    non_semantic: bool = False
    min_iter: int = 10
    max_iter: int = 50
    convergence_threshold: float = 1e-3
    probe_chunk: int | None = None
    mesh_probe: int = 0          # split the probes over this many ranks (0 = off)
    mesh_data: int = 0           # split strip frames / batch samples over ranks (0 = off)
    scaling_factor: float = 0.18215
    memory_bound: int = 0        # chunk strip denoise batches (0 = off)
    # return the edited strip as uint8 pixels, converted on the device
    pixel_output: bool = False
    result_folder: str = "./runs"
    save_images: bool = True
    use_sega: bool = False


class LCMEditPipeline(EngineExec):
    """Bound to unet_apply(z, t, context, w) -> eps (batched), decode(z) ->
    x and a prompt encoder str -> (1, seq, dim), all on `device`."""

    def __init__(self, unet_apply, decode, prompt_encoder, cfg: LCMEditConfig,
                 rng: RngStream, latent_shape=(64, 64, 4),
                 grid: LCMGrid | None = None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rng = rng
        self.unet_apply = unet_apply
        self.decode = decode
        self.prompt_encoder = prompt_encoder
        self.latent_shape = tuple(latent_shape)
        self.grid = grid or lcm_grid(cfg.num_inference_steps)
        self.w = cfg.guidance_scale - 1.0
        # noise_fn(step_idx, shape, dtype) -> array replaces the inter-step
        # noise draws (None: the "lcm-noise" stream)
        self.noise_fn = None
        self._noise_calls = 0
        self._emb_cache: dict[str, torch.Tensor] = {}
        # seconds per phase of the last run_* call
        self.timings: dict[str, float] = {}
        os.makedirs(cfg.result_folder, exist_ok=True)

    def emb(self, prompt: str) -> torch.Tensor:
        if prompt not in self._emb_cache:
            self._emb_cache[prompt] = self._tensor(self.prompt_encoder(prompt))
        return self._emb_cache[prompt]

    def _eps_fn(self, prompt: str) -> Callable:
        ctx = self.emb(prompt)

        def f(z, t):
            b = z.shape[0]
            c = ctx.expand((b,) + tuple(ctx.shape[-2:]))
            w = torch.full((b,), self.w, dtype=z.dtype, device=z.device)
            return self.unet_apply(z, t, c, w)

        return f

    @torch.no_grad()
    def forward_steps(self, z, prompt: str, start_idx: int = 0,
                      end_idx: int | None = None):
        """(z_next, denoised) over LCM grid steps [start_idx, end_idx). Each
        call draws from a fresh noise stream: repeated or chunked forward
        passes must not share the stochastic sampler's noise."""
        self._noise_calls += 1
        rng = self.rng.fork("lcm-noise").at_step(self._noise_calls - 1)
        return lcm_scan(self._eps_fn(prompt), self._tensor(z), self.grid, rng,
                        start_idx, end_idx, noise_fn=self.noise_fn)

    @torch.no_grad()
    def decode_to_image(self, den) -> np.ndarray:
        return _host(self.decode(self._tensor(den) / self.cfg.scaling_factor))

    @torch.no_grad()
    def decode_strips(self, den) -> np.ndarray:
        """Batched strip decode, chunked by cfg.memory_bound; with
        cfg.pixel_output the uint8 conversion runs on the device before the
        copy to the host."""
        def dec(zz):
            img = self.decode(zz / self.cfg.scaling_factor)
            return to_uint8_pixels_device(img) if self.cfg.pixel_output else img

        return _host(self.run_batched(dec, self._tensor(den)))

    def consistency_x0_fn(self, prompt: str, step_idx: int) -> Callable:
        """f(z_t) = decode(denoised(z_t)) at one grid step: the map whose
        Jacobian the basis takes."""
        f = self._eps_fn(prompt)
        t = float(self.grid.t[step_idx])

        def g(z):
            den = lcm_denoised(z, f(z, t), self.grid, step_idx)
            return self.decode(den / self.cfg.scaling_factor)

        return g

    def extract_basis(self, zt, prompt: str, mask, rank: int, v_init=None):
        """Subspace iteration of decode(denoised) at edit_t_idx; v_init: an
        explicit (rank, d) orthonormal start (matched-probe tests)."""
        cfg = self.cfg
        m = None if mask is None else self._tensor(mask)
        return subspace_iteration(
            self.consistency_x0_fn(prompt, cfg.edit_t_idx), self._tensor(zt),
            self.rng.fork(f"lcm-probes-{rank}"), rank=rank, mask=m,
            min_iter=cfg.min_iter, max_iter=cfg.max_iter,
            tol=cfg.convergence_threshold, probe_chunk=cfg.probe_chunk,
            v_init=v_init,
            probe_mesh=None if v_init is not None else self._probe_sharding())

    def extract_dual_basis(self, zt, prompt: str, mask, rank: int, rank_null: int):
        """Mask + complement-mask bases of the same consistency-through-
        decoder Jacobian in one fused iteration; probe streams as the two
        solo calls'."""
        cfg = self.cfg
        mw = self._tensor(mask)
        return dual_subspace_iteration(
            self.consistency_x0_fn(prompt, cfg.edit_t_idx), self._tensor(zt),
            self.rng.fork(f"lcm-probes-{rank}"),
            self.rng.fork(f"lcm-probes-{rank_null}"),
            rank_a=rank, rank_b=rank_null, mask_a=mw, mask_b=(mw == 0).float(),
            min_iter=cfg.min_iter, max_iter=cfg.max_iter,
            tol=cfg.convergence_threshold, probe_chunk=cfg.probe_chunk,
            probe_mesh=self._probe_sharding())

    def delta_zt_via_grad(self, zt, for_prompt: str, edit_prompt: str,
                          mask) -> torch.Tensor:
        """Prompt-delta direction: the gradient of <x0(edit) - x0(for),
        x0_edit(z)>, masked; unit norm, (1, d)."""
        g_for = self.consistency_x0_fn(for_prompt, self.cfg.edit_t_idx)
        g_edit = self.consistency_x0_fn(edit_prompt, self.cfg.edit_t_idx)
        mw = None if mask is None else self._tensor(mask)
        z = self._tensor(zt)
        with torch.no_grad():
            delta = g_edit(z) - g_for(z)
            if mw is not None:
                delta = delta * mw.to(delta.dtype)

        def h(zz):
            y = g_edit(zz)
            if mw is not None:
                y = y * mw.to(y.dtype)
            return (delta * y).sum()

        v = torch.func.grad(h)(z).reshape(1, -1).float()
        return v / torch.linalg.norm(v, dim=1, keepdim=True)

    # -- experiment internals -----------------------------------------------------

    def _resolve_basis(self, zt, for_prompt: str, edit_prompt: str, mask,
                       out_dir: str) -> torch.Tensor:
        """Modify direction (subspace iteration or prompt delta) and the
        null-space projection; a fresh non-semantic modify + null pair
        fuses into one dual iteration when their probe counts agree."""
        cfg = self.cfg
        use_dual = (cfg.non_semantic and cfg.null_space_projection and mask is not None
                    and padded_probe_count(cfg.pca_rank)
                    == padded_probe_count(cfg.pca_rank_null))
        vT_null_pre = None
        if use_dual:
            t0 = time.time()
            basis, nbasis = self.extract_dual_basis(
                zt, for_prompt, mask, cfg.pca_rank, cfg.pca_rank_null)
            vT_modify, vT_null_pre = basis.vT, nbasis.vT
            print(f"power method runtime == {time.time() - t0:.2f}s "
                  f"({basis.iters} iters, fused modify+null)")
        elif cfg.non_semantic:
            t0 = time.time()
            vT_modify = self.extract_basis(zt, for_prompt, mask, cfg.pca_rank).vT
            print(f"power method runtime == {time.time() - t0:.2f}s")
        else:
            vT_modify = self.delta_zt_via_grad(zt, for_prompt, edit_prompt, mask)

        if cfg.null_space_projection:
            if mask is None:
                raise ValueError("null-space projection requires a mask")
            vT_null = (vT_null_pre if vT_null_pre is not None
                       else self.extract_basis(zt, for_prompt, ~np.asarray(mask, bool),
                                               cfg.pca_rank_null).vT)
            vT = null_space_project(vT_modify, vT_null, cfg.pca_rank_null)
        else:
            vT = normalize_rows(vT_modify)
        self._submit_io(save_directions, os.path.join(out_dir, "basis", "vT.npz"),
                        _host(vT))
        return vT

    def _render_strip(self, zt, for_prompt: str, vT, out_dir: str):
        """Walk + completion consistency steps + decode: one chunked denoise
        of the frame batch and one batched decode."""
        cfg = self.cfg
        strip = x_space_guidance_strip(
            self._tensor(zt), vT[0], scale=cfg.x_space_guidance_scale,
            edit_step=cfg.x_space_guidance_edit_step,
            num_steps=cfg.x_space_guidance_num_step, vis_num=cfg.vis_num)
        den = self.run_batched(
            lambda ss: self.forward_steps(ss, for_prompt, cfg.edit_t_idx, None)[1],
            strip)
        img = self.decode_strips(den)
        if cfg.save_images:
            self._submit_io(save_image_grid, img, os.path.join(
                out_dir, f"edit-lcm-idx{cfg.edit_t_idx}.png"))
        return img, den

    # -- experiments --------------------------------------------------------------

    def run_edit_null_space_projection_zt(
            self, for_prompt: str, edit_prompt: str = "", zT=None, mask=None,
            sample_name: str = "sample", vT_path: str | None = None) -> dict:
        """The LCM edit of one latent. mask: pixel-space bool (1, H, W, 3) or
        None. vT_path loads a saved direction file instead of computing the
        basis. Returns numpy zt, vT, the decoded strip ("image") and its
        latents ("denoised"), and out_dir; with cfg.use_sega, {"image": ...}."""
        cfg = self.cfg
        self.timings = {}
        h, w, c = self.latent_shape
        zT = (self.rng.fork("zT").normal((1, h, w, c), device=self.device)
              if zT is None else self._tensor(zT))
        out_dir = os.path.join(cfg.result_folder, sample_name)
        os.makedirs(out_dir, exist_ok=True)

        with _Phase(self.timings, "generate", self.device):
            zt, _ = self.forward_steps(zT, for_prompt, 0, cfg.edit_t_idx)
        if cfg.use_sega:
            with _Phase(self.timings, "strips", self.device):
                _, den = self.forward_steps(zt, edit_prompt, cfg.edit_t_idx, None)
                img = self.decode_to_image(den)
            if cfg.save_images and is_main_process():
                save_image_grid(img, os.path.join(out_dir, "sega.png"))
            return {"image": img}

        with _Phase(self.timings, "basis", self.device):
            if vT_path:
                vT = self._tensor(load_directions(vT_path)[0])
            else:
                vT = self._resolve_basis(zt, for_prompt, edit_prompt, mask, out_dir)
        with _Phase(self.timings, "strips", self.device):
            img, den = self._render_strip(zt, for_prompt, vT, out_dir)
        with _Phase(self.timings, "io", self.device):
            self.flush_io()
        return {"zt": _host(zt), "vT": _host(vT), "image": img,
                "denoised": _host(den), "out_dir": out_dir}

    def run_edit_batch(self, for_prompt: str, edit_prompt: str = "", zTs=None,
                       masks: np.ndarray | None = None,
                       sample_names: list[str] | None = None) -> list[dict]:
        """The edit over N seeds: ONE batched consistency forward runs every
        sample to edit_t_idx; bases and strips per sample. An all-False mask
        row means that sample has no mask."""
        cfg = self.cfg
        self.timings = {}
        n = zTs.shape[0]
        with _Phase(self.timings, "generate", self.device):
            zts = self.shard_samples(lambda z: self.forward_steps(
                z, for_prompt, 0, cfg.edit_t_idx)[0], self._tensor(zTs))
        names = sample_names or [f"batch{i:03d}" for i in range(n)]
        results = []
        for i in range(n):
            out_dir = os.path.join(cfg.result_folder, names[i])
            os.makedirs(out_dir, exist_ok=True)
            mask_i = (masks[i:i + 1] if masks is not None
                      and np.asarray(masks[i]).any() else None)
            with _Phase(self.timings, "basis", self.device):
                vT = self._resolve_basis(zts[i:i + 1], for_prompt, edit_prompt,
                                         mask_i, out_dir)
            with _Phase(self.timings, "strips", self.device):
                img, den = self._render_strip(zts[i:i + 1], for_prompt, vT, out_dir)
            results.append({"zt": _host(zts[i:i + 1]), "vT": _host(vT), "image": img,
                            "denoised": _host(den), "out_dir": out_dir})
        with _Phase(self.timings, "io", self.device):
            self.flush_io()
        return results

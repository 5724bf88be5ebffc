"""LOCO-Edit proper: the unconditional-DDPM edit engine (port of
loco_edit_tpu/pipelines/uncond.py).

The flagship path:

  DDIM-invert a real image -> denoise to edit_t -> masked PMP-Jacobian basis
  (cached on disk) -> null-space projection against the complement-mask basis
  -> +/- x-space-guidance walks per principal component -> finish denoising
  with the eta=1 performance-boosting tail -> PNG strips + direction files.

Device work is eager PyTorch on the pipeline's device; the host moves PNGs
and .npz caches on an IO thread (EngineExec). Randomness comes from named
forks of the run's RngStream with the JAX package's stream names, so a test
can hand the pipeline a stream that yields the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from loco_edit_tpu_torch.core.device import resolve_device
from loco_edit_tpu_torch.core.mesh import is_main_process
from loco_edit_tpu_torch.core.rng import RngStream
from loco_edit_tpu_torch.diffusion import LinspaceDDIM, ddim_generate, ddim_invert
from loco_edit_tpu_torch.editing import (
    EditBasis,
    dual_subspace_iteration,
    load_directions,
    mask_cache_tag,
    null_space_project,
    normalize_rows,
    save_directions,
    subspace_iteration,
)
from loco_edit_tpu_torch.editing.pullback import (eps_pullback_fn,
                                                  padded_probe_count,
                                                  pmp_pullback_fn)
from loco_edit_tpu_torch.models.base import Denoiser
from loco_edit_tpu_torch.pipelines.common import (EngineExec, _host, _Phase,
                                                  concat_pc_strips, split_pc_strips)
from loco_edit_tpu_torch.utils.io import save_image_grid, to_uint8_pixels_device


@dataclasses.dataclass
class UncondEditConfig:
    for_steps: int = 100
    inv_steps: int = 100
    # fixed-point exact-inversion refinement per step (0 = reference-exact)
    inv_refine_steps: int = 0
    edit_t: float = 0.6
    performance_boosting_t: float = 0.2
    x_space_guidance_scale: float = 0.5
    x_space_guidance_edit_step: float = 1.0
    x_space_guidance_num_step: int = 16
    vis_num: int = 4
    vis_num_pc: int = 5
    pca_rank: int = 5
    pca_rank_null: int = 5
    null_space_projection: bool = True
    encoder_decoder_by_et: bool = False   # pull back eps instead of PMP
    min_iter: int = 10
    max_iter: int = 50
    convergence_threshold: float = 1e-4
    probe_chunk: int | None = None
    mesh_probe: int = 0          # split the probes over this many ranks (0 = off)
    mesh_data: int = 0           # split strip frames / batch samples over ranks (0 = off)
    memory_bound: int = 0        # chunk strip denoise batches (0 = no chunking)
    # return edited strips as uint8 pixels, converted on the device
    pixel_output: bool = False
    result_folder: str = "./runs"
    save_images: bool = True


class UncondEditPipeline(EngineExec):
    """The flagship edit engine on one device (the card unless
    device="cpu"; raises when no card is present)."""

    def __init__(self, denoiser: Denoiser, cfg: UncondEditConfig,
                 rng: RngStream, scheduler: LinspaceDDIM | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if torch.device(denoiser.device) != self.device:
            raise ValueError(f"denoiser is on {denoiser.device}, pipeline on "
                             f"{self.device}")
        self.denoiser = denoiser
        self.cfg = cfg
        self.rng = rng
        self.scheduler = scheduler or LinspaceDDIM()
        self.gen_grid = self.scheduler.generation_grid(cfg.for_steps)
        self.inv_grid = self.scheduler.inversion_grid(cfg.inv_steps)
        self.edit_t_idx = self.scheduler.nearest_step_index(cfg.for_steps, cfg.edit_t)
        self.boost_eta = self.scheduler.boost_eta_flags(
            cfg.for_steps, cfg.performance_boosting_t)
        self._boost_calls = 0   # per-call noise-stream counter (see generate)
        # seconds per phase of the last run_edit_null_space_projection,
        # run_edit_batch or group_edit call
        self.timings: dict[str, float] = {}
        os.makedirs(cfg.result_folder, exist_ok=True)

    @torch.no_grad()
    def invert(self, x0) -> torch.Tensor:
        return ddim_invert(self.denoiser.eps_fn, self._tensor(x0), self.inv_grid,
                           refine_steps=int(self.cfg.inv_refine_steps))

    @torch.no_grad()
    def generate(self, xt, start_idx: int = 0, end_idx: int | None = None,
                 boost: bool = False) -> torch.Tensor:
        # A fresh noise stream per boosted call: the call counter is folded
        # into the stream, as the JAX package folds it into its key.
        noise = self.rng.fork("boost-eta").at_step(self._boost_calls)
        if boost:
            self._boost_calls += 1
        return ddim_generate(self.denoiser.eps_fn, self._tensor(xt),
                             self.gen_grid, start_idx=start_idx,
                             end_idx=end_idx,
                             eta=self.boost_eta if boost else None, rng=noise)

    def generate_chunked(self, xt, start_idx: int = 0,
                         end_idx: int | None = None, boost: bool = False):
        """generate(), chunking the batch by cfg.memory_bound."""
        return self.run_batched(
            lambda c: self.generate(c, start_idx, end_idx, boost), self._tensor(xt))

    def pullback_fn(self):
        t = float(self.gen_grid.t[self.edit_t_idx])
        ab = float(self.gen_grid.alpha_bar[self.edit_t_idx])
        if self.cfg.encoder_decoder_by_et:
            return eps_pullback_fn(self.denoiser.eps_fn, t)
        return pmp_pullback_fn(self.denoiser.eps_fn, ab, t)

    def extract_basis(self, xt, mask, rank: int,
                      stream: str = "probes") -> EditBasis:
        cfg = self.cfg
        m = None if mask is None else self._tensor(mask)
        return subspace_iteration(
            self.pullback_fn(), self._tensor(xt),
            self.rng.fork(f"{stream}-r{rank}"), rank=rank, mask=m,
            min_iter=cfg.min_iter, max_iter=cfg.max_iter,
            tol=cfg.convergence_threshold, probe_chunk=cfg.probe_chunk,
            probe_mesh=self._probe_sharding())

    def extract_dual_basis(self, xt, mask, rank: int, rank_null: int):
        """Mask + complement-mask bases of the SAME Jacobian in one fused
        iteration; the complement is binarized (any nonzero weight counts as
        inside), as the solo path's ~mask is."""
        cfg = self.cfg
        mw = self._tensor(mask)
        return dual_subspace_iteration(
            self.pullback_fn(), self._tensor(xt),
            self.rng.fork(f"probes-r{rank}"),
            self.rng.fork(f"probes-null-r{rank_null}"),
            rank_a=rank, rank_b=rank_null, mask_a=mw,
            mask_b=(mw == 0).float(), min_iter=cfg.min_iter,
            max_iter=cfg.max_iter, tol=cfg.convergence_threshold,
            probe_chunk=cfg.probe_chunk,
            probe_mesh=self._probe_sharding())

    # -- the flagship experiment ----------------------------------------------

    def _save_vT(self, path: str, vT: torch.Tensor, **meta):
        self._submit_io(save_directions, path, _host(vT), **meta)

    def _resolve_basis(self, xt, mask, out_dir, random_edit: bool = False):
        """Disk-cached basis resolution for ONE sample: modify cache -> fused
        dual when both bases are fresh and their probe counts agree -> solo
        runs otherwise; null-space projection or row normalization; per-pc
        direction files."""
        cfg = self.cfg
        self.flush_io()   # cache-existence checks below must see all writes
        basis_dir = os.path.join(out_dir, "basis", f"local_basis-{cfg.edit_t}T")
        tag = mask_cache_tag(mask)
        mod_path = os.path.join(
            basis_dir, f"vT-modify-rank-{cfg.pca_rank}-{tag}.npz")
        null_path = os.path.join(
            basis_dir, f"vT-null-{cfg.pca_rank_null}-{tag}.npz")

        vT_null_pre = None
        use_dual = (
            cfg.null_space_projection and mask is not None
            and not os.path.exists(mod_path)
            and not os.path.exists(null_path)
            and padded_probe_count(cfg.pca_rank)
            == padded_probe_count(cfg.pca_rank_null))

        if os.path.exists(mod_path):
            vT_modify = self._tensor(load_directions(mod_path)[0])
        elif use_dual:
            t0 = time.time()
            basis, nbasis = self.extract_dual_basis(
                xt, mask, cfg.pca_rank, cfg.pca_rank_null)
            vT_modify, vT_null_pre = basis.vT, nbasis.vT
            self._save_vT(mod_path, vT_modify, edit_t=cfg.edit_t, rank=cfg.pca_rank)
            self._save_vT(null_path, vT_null_pre, edit_t=cfg.edit_t,
                          rank=cfg.pca_rank_null)
            print(f"power method runtime == {time.time() - t0:.2f}s "
                  f"({basis.iters} iters, fused modify+null)")
        else:
            t0 = time.time()
            basis = self.extract_basis(xt, mask, cfg.pca_rank)
            vT_modify = basis.vT
            self._save_vT(mod_path, vT_modify, edit_t=cfg.edit_t, rank=cfg.pca_rank)
            print(f"power method runtime == {time.time() - t0:.2f}s "
                  f"({basis.iters} iters)")

        if random_edit:
            vT_modify = self.rng.fork("random-edit").normal(
                vT_modify.shape, device=self.device)

        if cfg.null_space_projection:
            if mask is None:
                raise ValueError("null-space projection requires a mask")
            if vT_null_pre is not None:
                vT_null = vT_null_pre
            elif os.path.exists(null_path):
                vT_null = self._tensor(load_directions(null_path)[0])
            else:
                t0 = time.time()
                nbasis = self.extract_basis(
                    xt, ~np.asarray(mask, bool), cfg.pca_rank_null,
                    stream="probes-null")
                vT_null = nbasis.vT
                self._save_vT(null_path, vT_null, edit_t=cfg.edit_t,
                              rank=cfg.pca_rank_null)
                print(f"null-space power method runtime == {time.time() - t0:.2f}s")
            vT = null_space_project(vT_modify, vT_null, cfg.pca_rank_null)
        else:
            vT = normalize_rows(vT_modify)

        basis_name = (f"edit_{cfg.edit_t}T_null_proj_{cfg.null_space_projection}"
                      f"_rank{cfg.pca_rank_null}_scale_{cfg.x_space_guidance_scale}")
        for pc in range(vT.shape[0]):
            self._save_vT(os.path.join(basis_dir, f"pc_{pc:03d}-vT.npz"),
                          vT[pc:pc + 1], edit_t=cfg.edit_t, pc=pc)
        return vT, basis_name

    def _render_strips(self, xt, vT, out_dir, basis_name):
        """Walks + completion denoise for ONE sample: all principal
        components' strips concatenate into one frame batch."""
        cfg = self.cfg
        n_pc = min(cfg.vis_num_pc, vT.shape[0])
        per_pc, frames = concat_pc_strips(
            xt, vT, n_pc, scale=cfg.x_space_guidance_scale,
            edit_step=cfg.x_space_guidance_edit_step,
            num_steps=cfg.x_space_guidance_num_step, vis_num=cfg.vis_num)
        if not per_pc:
            return {}
        edited = self.generate_chunked(frames, self.edit_t_idx, None, boost=True)
        if cfg.pixel_output:
            edited = to_uint8_pixels_device(edited)
        strips = split_pc_strips(per_pc, edited)
        if cfg.save_images:
            for pc, strip in strips.items():
                self._submit_io(save_image_grid, strip,
                                os.path.join(out_dir, f"edit-{basis_name}-pc{pc:03d}.png"))
        return strips

    def run_edit_null_space_projection(
        self, x0: np.ndarray | None = None, xT: np.ndarray | None = None,
        mask: np.ndarray | None = None, sample_name: str = "sample",
        vT_path: str | None = None, random_edit: bool = False,
    ) -> dict:
        """Full LOCO-Edit on one sample.

        Provide x0 (a real image -> DDIM inversion) or xT (a latent), NHWC in
        [-1, 1]. mask is boolean NHWC (or None for unmasked). vT_path loads a
        previously saved direction file instead of computing the basis
        (direction transfer). Returns a dict with xt, vT, per-pc edited
        strips (numpy).
        """
        cfg = self.cfg
        if (x0 is None) == (xT is None):
            raise ValueError("pass exactly one of x0 / xT")
        self.timings = {}
        with _Phase(self.timings, "invert", self.device):
            xT = self.invert(x0) if xT is None else self._tensor(xT)
        with _Phase(self.timings, "generate", self.device):
            xt = self.generate(xT, 0, self.edit_t_idx)

        out_dir = os.path.join(cfg.result_folder, sample_name)
        os.makedirs(out_dir, exist_ok=True)

        with _Phase(self.timings, "basis", self.device):
            if vT_path:
                vT = self._tensor(load_directions(vT_path)[0])
                basis_name = (f"edit_{cfg.edit_t}T-load-basis-"
                              f"{os.path.basename(vT_path)}")
            else:
                vT, basis_name = self._resolve_basis(xt, mask, out_dir,
                                                     random_edit=random_edit)

        with _Phase(self.timings, "strips", self.device):
            strips = self._render_strips(xt, vT, out_dir, basis_name)
        with _Phase(self.timings, "io", self.device):
            self.flush_io()   # every artifact is on disk when the call returns
        return {"xt": _host(xt), "vT": _host(vT), "strips": strips,
                "edit_t_idx": self.edit_t_idx, "out_dir": out_dir}

    def run_edit_batch(
        self, x0s: np.ndarray | None = None, xTs: np.ndarray | None = None,
        masks: np.ndarray | None = None,
        sample_names: list[str] | None = None,
    ) -> list[dict]:
        """Throughput form of run_edit_null_space_projection over N samples.

        ONE inversion and ONE generation to edit_t run the whole (N, H, W, C)
        batch; the bases and the strip denoise stay per sample. Per-sample
        disk artifacts (basis caches, direction files, PNGs) are written
        exactly as N single runs would.

        masks: (N, H, W, C) boolean. Returns one result dict per sample.
        """
        cfg = self.cfg
        if (x0s is None) == (xTs is None):
            raise ValueError("pass exactly one of x0s / xTs")
        n = (x0s if xTs is None else xTs).shape[0]
        if masks is None or masks.shape[0] != n:
            raise ValueError(f"run_edit_batch needs one mask per sample ({n})")
        names = sample_names or [f"batch{i:03d}" for i in range(n)]
        self.timings = {}
        with _Phase(self.timings, "invert", self.device):
            xTs = (self.shard_samples(self.invert, self._tensor(x0s)) if xTs is None
                   else self._tensor(xTs))
        with _Phase(self.timings, "generate", self.device):
            xts = self.shard_samples(lambda x: self.generate(x, 0, self.edit_t_idx), xTs)

        results = []
        for i in range(n):
            out_dir = os.path.join(cfg.result_folder, names[i])
            os.makedirs(out_dir, exist_ok=True)
            with _Phase(self.timings, "basis", self.device):
                vT, basis_name = self._resolve_basis(
                    xts[i:i + 1], masks[i:i + 1], out_dir)
            with _Phase(self.timings, "strips", self.device):
                strips = self._render_strips(xts[i:i + 1], vT, out_dir, basis_name)
            results.append({"xt": _host(xts[i:i + 1]), "vT": _host(vT),
                            "strips": strips, "edit_t_idx": self.edit_t_idx,
                            "out_dir": out_dir})
        with _Phase(self.timings, "io", self.device):
            self.flush_io()
        return results

    def group_edit(self, xT, vT_paths: list[str],
                   sample_name: str = "group") -> np.ndarray:
        """Sequential composition of saved directions: apply each direction's
        full walk offset (scale * num_step) in turn, and denoise every stage
        (the starting xt included) in one boosted batch."""
        cfg = self.cfg
        self.timings = {}
        with _Phase(self.timings, "generate", self.device):
            xt = self.generate(xT, 0, self.edit_t_idx)
        frames = [xt]
        cur = xt
        for p in vT_paths:
            vT, _ = load_directions(p)
            vk = self._tensor(vT[0]).reshape(xt.shape[1:])
            cur = cur + cfg.x_space_guidance_scale * cfg.x_space_guidance_num_step * vk
            frames.append(cur)
        with _Phase(self.timings, "strips", self.device):
            edited = self.generate_chunked(torch.cat(frames, dim=0),
                                           self.edit_t_idx, None, boost=True)
            if cfg.pixel_output:
                edited = to_uint8_pixels_device(edited)
            edited = _host(edited)
        if cfg.save_images and is_main_process():
            save_image_grid(edited, os.path.join(cfg.result_folder, sample_name,
                                                 "group_edit.png"))
        return edited

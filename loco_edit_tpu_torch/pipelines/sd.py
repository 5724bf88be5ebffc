"""T-LOCO on Stable Diffusion: the latent z-space edit engine (port of
loco_edit_tpu/pipelines/sd.py).

CFG denoising with the prompt-combination modes (editing/cfg.py), DDIM
inversion of a real image through the VAE encoder, the PMP decoded through
the VAE decoder as the map whose Jacobian the subspace iteration takes,
text-supervised directions from the prompt-delta vector-Jacobian product,
null-space projection, x-space-guidance walks in z_t, and the SEGA ablation
branch. Every principal component's strip is concatenated into one frame
batch: one chunked denoise and one batched decode.

Device work is eager PyTorch on the pipeline's device (the card unless
device="cpu"). Randomness comes from named forks of the run's RngStream with
the JAX package's stream names ("zT", "vae-sample", "probes-{rank}-{mode}"),
so a test can hand the pipeline a stream that yields the JAX package's
draws. The JAX package's probe-chunk default applies to the TPU only; here
probes are all batched unless cfg.probe_chunk is set.
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
from loco_edit_tpu_torch.diffusion import LinspaceDDIM, ddim_generate, ddim_invert
from loco_edit_tpu_torch.editing import (
    dual_subspace_iteration,
    load_directions,
    mask_cache_tag,
    normalize_rows,
    null_space_project,
    save_directions,
    subspace_iteration,
)
from loco_edit_tpu_torch.editing.cfg import cfg_eps
from loco_edit_tpu_torch.editing.pullback import padded_probe_count
from loco_edit_tpu_torch.pipelines.common import (EngineExec, _host, _Phase,
                                                  concat_pc_strips, split_pc_strips)
from loco_edit_tpu_torch.utils.io import save_image_grid, to_uint8_pixels_device


@dataclasses.dataclass
class SDEditConfig:
    for_steps: int = 100
    inv_steps: int = 100
    # fixed-point exact-inversion refinement per step (0 = reference-exact)
    inv_refine_steps: int = 0
    edit_t: float = 0.7
    guidance_scale: float = 7.5
    guidance_scale_edit: float = 4.0
    x_space_guidance_scale: float = 1.0
    x_space_guidance_edit_step: float = 1.0
    x_space_guidance_num_step: int = 8
    vis_num: int = 4
    vis_num_pc: int = 1
    pca_rank: int = 2
    pca_rank_null: int = 2
    null_space_projection: bool = True
    min_iter: int = 10
    max_iter: int = 50
    convergence_threshold: float = 1e-3
    probe_chunk: int | None = None
    mesh_probe: int = 0          # split the probes over this many ranks (0 = off)
    mesh_data: int = 0           # split strip frames / batch samples over ranks (0 = off)
    scaling_factor: float = 0.18215
    t_max: int = 999
    memory_bound: int = 0        # chunk strip denoise / decode batches (0 = off)
    # return edited strips as uint8 pixels, converted on the device
    pixel_output: bool = False
    result_folder: str = "./runs"
    save_images: bool = True
    tilda_v_score_type: str = "null+(for-null)+(edit-null)"
    use_sega: bool = False


class SDEditPipeline(EngineExec):
    """Bound to unet_apply(z, t, context) -> eps (batched), decode(z) -> x,
    encode(x, rng) -> z (a sampled, scaled latent; rng a stream) and a
    prompt encoder str -> (1, seq, dim), all on `device`."""

    def __init__(self, unet_apply, decode, encode, prompt_encoder,
                 cfg: SDEditConfig, rng: RngStream, latent_shape=(64, 64, 4),
                 scheduler: LinspaceDDIM | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rng = rng
        self.decode = decode
        self.encode = encode
        self.latent_shape = tuple(latent_shape)
        self.unet_apply = unet_apply
        # SD checkpoints are trained on the scaled_linear beta table
        self.scheduler = scheduler or LinspaceDDIM(
            t_max=cfg.t_max, noise_schedule="scaled_linear")
        self.gen_grid = self.scheduler.generation_grid(cfg.for_steps)
        self.inv_grid = self.scheduler.inversion_grid(cfg.inv_steps)
        self.edit_t_idx = self.scheduler.nearest_step_index(cfg.for_steps, cfg.edit_t)
        self.prompt_encoder = prompt_encoder
        self._emb_cache: dict[str, torch.Tensor] = {}
        # seconds per phase of the last run_edit_null_space_projection_zt or
        # run_edit_batch call
        self.timings: dict[str, float] = {}
        os.makedirs(cfg.result_folder, exist_ok=True)

    # -- prompts ---------------------------------------------------------------

    def emb(self, prompt: str) -> torch.Tensor:
        if prompt not in self._emb_cache:
            self._emb_cache[prompt] = self._tensor(self.prompt_encoder(prompt))
        return self._emb_cache[prompt]

    def prompt_set(self, for_prompt: str, edit_prompt: str = "") -> dict:
        return {"for": self.emb(for_prompt), "edit": self.emb(edit_prompt),
                "null": self.emb("")}

    # -- denoising primitives ---------------------------------------------------

    def _eps_fn(self, prompts: dict, mode: str) -> Callable:
        enabled = self.cfg.guidance_scale > 1.0
        return lambda z, t: cfg_eps(
            self.unet_apply, z, t, prompts, mode, self.cfg.guidance_scale,
            self.cfg.guidance_scale_edit, enabled=enabled)

    @torch.no_grad()
    def generate(self, zt, prompts: dict, mode: str, start_idx: int = 0,
                 end_idx: int | None = None) -> torch.Tensor:
        return ddim_generate(self._eps_fn(prompts, mode), self._tensor(zt),
                             self.gen_grid, start_idx=start_idx, end_idx=end_idx)

    def generate_chunked(self, zt, prompts: dict, mode: str, start_idx: int = 0,
                         end_idx: int | None = None) -> torch.Tensor:
        """generate(), chunking the frame batch by cfg.memory_bound."""
        return self.run_batched(
            lambda c: self.generate(c, prompts, mode, start_idx, end_idx),
            self._tensor(zt))

    @torch.no_grad()
    def invert(self, x0, inv_prompt: str = "") -> torch.Tensor:
        """Real image -> sampled VAE latent -> ascending DDIM, without CFG (a
        single pass under the inversion prompt)."""
        z0 = self.encode(self._tensor(x0), self.rng.fork("vae-sample"))
        prompts = {"for": self.emb(inv_prompt), "edit": self.emb(""),
                   "null": self.emb("")}
        f = lambda z, t: cfg_eps(  # noqa: E731
            self.unet_apply, z, t, prompts, "null+(for-null)",
            self.cfg.guidance_scale, enabled=False)
        return ddim_invert(f, z0, self.inv_grid,
                           refine_steps=int(self.cfg.inv_refine_steps))

    @torch.no_grad()
    def decode_to_image(self, z) -> np.ndarray:
        return _host(self.decode(self._tensor(z) / self.cfg.scaling_factor))

    @torch.no_grad()
    def decode_strips(self, z) -> np.ndarray:
        """Batched strip decode over the whole frame batch, chunked by
        cfg.memory_bound; with cfg.pixel_output the uint8 conversion runs on
        the device before the copy to the host."""
        def dec(zz):
            img = self.decode(zz / self.cfg.scaling_factor)
            return to_uint8_pixels_device(img) if self.cfg.pixel_output else img

        return _host(self.run_batched(dec, self._tensor(z)))

    # -- pullback objects --------------------------------------------------------

    def pmp_through_decoder(self, prompts: dict, mode: str) -> Callable:
        """f(z_t) = decode(PMP(z_t)): the Jacobian target."""
        t = float(self.gen_grid.t[self.edit_t_idx])
        ab = float(self.gen_grid.alpha_bar[self.edit_t_idx])
        eps = self._eps_fn(prompts, mode)

        def f(z):
            z0 = (z - eps(z, t) * np.sqrt(1.0 - ab)) / np.sqrt(ab)
            return self.decode(z0 / self.cfg.scaling_factor)

        return f

    def extract_basis(self, zt, prompts: dict, mode: str, mask, rank: int):
        cfg = self.cfg
        m = None if mask is None else self._tensor(mask)
        return subspace_iteration(
            self.pmp_through_decoder(prompts, mode), self._tensor(zt),
            self.rng.fork(f"probes-{rank}-{mode}"), rank=rank, mask=m,
            min_iter=cfg.min_iter, max_iter=cfg.max_iter,
            tol=cfg.convergence_threshold, probe_chunk=cfg.probe_chunk,
            probe_mesh=self._probe_sharding())

    def extract_dual_basis(self, zt, prompts: dict, mode: str, mask,
                           rank: int, rank_null: int):
        """Mask + complement-mask bases of the SAME decode(PMP) Jacobian in
        one fused iteration; probe streams as the two solo calls'. The
        complement is binarized (any nonzero weight counts as inside)."""
        cfg = self.cfg
        mw = self._tensor(mask)
        return dual_subspace_iteration(
            self.pmp_through_decoder(prompts, mode), self._tensor(zt),
            self.rng.fork(f"probes-{rank}-{mode}"),
            self.rng.fork(f"probes-{rank_null}-{mode}"),
            rank_a=rank, rank_b=rank_null, mask_a=mw, mask_b=(mw == 0).float(),
            min_iter=cfg.min_iter, max_iter=cfg.max_iter,
            tol=cfg.convergence_threshold, probe_chunk=cfg.probe_chunk,
            probe_mesh=self._probe_sharding())

    def delta_zt_via_grad(self, zt, prompts: dict, mask, mode: str) -> torch.Tensor:
        """Text-supervised direction: the gradient of <delta_x0,
        decode(PMP(z))> under `mode`, where delta_x0 = decode(PMP under
        `mode`) - decode(PMP under null+(for-null)), masked; unit norm,
        (1, d)."""
        f_base = self.pmp_through_decoder(prompts, "null+(for-null)")
        f_mode = self.pmp_through_decoder(prompts, mode)
        mw = None if mask is None else self._tensor(mask)
        z = self._tensor(zt)
        with torch.no_grad():
            delta = f_mode(z) - f_base(z)
            if mw is not None:
                delta = delta * mw.to(delta.dtype)

        def g(zz):
            y = f_mode(zz)
            if mw is not None:
                y = y * mw.to(y.dtype)
            return (delta * y).sum()

        v = torch.func.grad(g)(z).reshape(1, -1).float()
        return v / torch.linalg.norm(v, dim=1, keepdim=True)

    # -- experiment internals -----------------------------------------------------

    def _save_vT(self, path: str, vT: torch.Tensor):
        self._submit_io(save_directions, path, _host(vT), edit_t=self.cfg.edit_t)

    def _resolve_basis_zt(self, zt, prompts: dict, mask, out_dir: str,
                          semantic: bool) -> torch.Tensor:
        """Disk-cached basis for ONE latent: reload the modify (+ null) files
        of this rank, edit_t and mask when all exist; else the fused dual
        iteration when both are fresh, solo iterations otherwise, or the
        text-supervised direction."""
        cfg = self.cfg
        self.flush_io()   # cache-existence checks must see queued writes
        basis_dir = os.path.join(out_dir, "basis")
        tag = mask_cache_tag(mask)
        modify_path = os.path.join(
            basis_dir, f"vT-modify-{cfg.edit_t}T-rank{cfg.pca_rank}-{tag}.npz")
        null_path = os.path.join(
            basis_dir, f"vT-null-{cfg.edit_t}T-rank{cfg.pca_rank_null}-{tag}.npz")
        cached = (not semantic and os.path.exists(modify_path)
                  and (not cfg.null_space_projection or os.path.exists(null_path)))
        vT_null_pre = None
        use_dual = (not semantic and not cached and cfg.null_space_projection
                    and mask is not None
                    and padded_probe_count(cfg.pca_rank)
                    == padded_probe_count(cfg.pca_rank_null))

        if cached:
            vT_modify = self._tensor(load_directions(modify_path)[0])
        elif semantic:
            vT_modify = self.delta_zt_via_grad(zt, prompts, mask, cfg.tilda_v_score_type)
        elif use_dual:
            t0 = time.time()
            basis, nbasis = self.extract_dual_basis(
                zt, prompts, "null+(for-null)", mask, cfg.pca_rank, cfg.pca_rank_null)
            vT_modify, vT_null_pre = basis.vT, nbasis.vT
            print(f"power method runtime == {time.time() - t0:.2f}s "
                  f"({basis.iters} iters, fused modify+null)")
            self._save_vT(modify_path, vT_modify)
            self._save_vT(null_path, vT_null_pre)
        else:
            t0 = time.time()
            vT_modify = self.extract_basis(zt, prompts, "null+(for-null)", mask,
                                           cfg.pca_rank).vT
            print(f"power method runtime == {time.time() - t0:.2f}s")
            self._save_vT(modify_path, vT_modify)

        if cfg.null_space_projection:
            if mask is None:
                raise ValueError("null-space projection requires a mask")
            if vT_null_pre is not None:
                vT_null = vT_null_pre
            elif cached:
                vT_null = self._tensor(load_directions(null_path)[0])
            else:
                vT_null = self.extract_basis(zt, prompts, "null+(for-null)",
                                             ~np.asarray(mask, bool),
                                             cfg.pca_rank_null).vT
                if not semantic:
                    self._save_vT(null_path, vT_null)
            vT = null_space_project(vT_modify, vT_null, cfg.pca_rank_null)
        else:
            vT = normalize_rows(vT_modify)
        self._save_vT(os.path.join(basis_dir, "vT.npz"), vT)
        return vT

    def _render_strips_zt(self, zt, prompts: dict, vT, out_dir: str):
        """Walks + completion denoise + decode for ONE latent, every
        principal component's strip in one frame batch."""
        cfg = self.cfg
        n_pc = min(cfg.vis_num_pc, vT.shape[0])
        per_pc, big = concat_pc_strips(
            self._tensor(zt), vT, n_pc, scale=cfg.x_space_guidance_scale,
            edit_step=cfg.x_space_guidance_edit_step,
            num_steps=cfg.x_space_guidance_num_step, vis_num=cfg.vis_num)
        strips, z0_strips = {}, {}
        if n_pc:
            z0_all = self.generate_chunked(big, prompts, "null+(for-null)",
                                           self.edit_t_idx, None)
            strips = split_pc_strips(per_pc, self.decode_strips(z0_all))
            z0_strips = split_pc_strips(per_pc, z0_all)
            if cfg.save_images:
                for pc, img in strips.items():
                    self._submit_io(
                        save_image_grid, img,
                        os.path.join(out_dir, f"edit-zt-{cfg.edit_t}T-pc{pc:03d}.png"))
        return strips, z0_strips

    # -- experiments --------------------------------------------------------------

    def run_edit_null_space_projection_zt(
            self, for_prompt: str, edit_prompt: str = "", zT=None, mask=None,
            sample_name: str = "sample", semantic: bool = False,
            vT_path: str | None = None) -> dict:
        """Unsupervised (subspace iteration) or text-supervised
        (semantic=True) z-space edit of one latent. mask: pixel-space bool
        (1, H, W, 3) or None. vT_path loads a saved direction file instead of
        computing the basis. Returns numpy zt, vT, per-pc strips (decoded)
        and z0_strips, and out_dir; with cfg.use_sega, {"image": ...}."""
        cfg = self.cfg
        self.timings = {}
        prompts = self.prompt_set(for_prompt, edit_prompt)
        h, w, c = self.latent_shape
        zT = (self.rng.fork("zT").normal((1, h, w, c), device=self.device)
              if zT is None else self._tensor(zT))
        out_dir = os.path.join(cfg.result_folder, sample_name)
        os.makedirs(out_dir, exist_ok=True)

        with _Phase(self.timings, "generate", self.device):
            zt = self.generate(zT, prompts, "null+(for-null)", 0, self.edit_t_idx)
        if cfg.use_sega:
            # SEGA ablation: no basis, edit-guided denoising from edit_t
            with _Phase(self.timings, "strips", self.device):
                z0 = self.generate(zt, prompts, "null+(for-null)+(edit-null)",
                                   self.edit_t_idx, None)
                img = self.decode_to_image(z0)
            if cfg.save_images and is_main_process():
                save_image_grid(img, os.path.join(out_dir, "sega.png"))
            return {"image": img}

        with _Phase(self.timings, "basis", self.device):
            if vT_path:
                vT = self._tensor(load_directions(vT_path)[0])
            else:
                vT = self._resolve_basis_zt(zt, prompts, mask, out_dir, semantic)
        with _Phase(self.timings, "strips", self.device):
            strips, z0_strips = self._render_strips_zt(zt, prompts, vT, out_dir)
        with _Phase(self.timings, "io", self.device):
            self.flush_io()   # every artifact is on disk when the call returns
        return {"zt": _host(zt), "vT": _host(vT), "strips": strips,
                "z0_strips": z0_strips, "out_dir": out_dir}

    def run_edit_batch(self, for_prompt: str, edit_prompt: str = "", zTs=None,
                       x0s=None, masks=None, sample_names: list[str] | None = None,
                       semantic: bool = False) -> list[dict]:
        """The edit over N samples: ONE batched generation to edit_t (or
        inversion, for real images x0s); bases and strips per sample, with
        per-sample artifacts exactly as N single runs would write them. An
        all-False mask row means that sample has no mask."""
        cfg = self.cfg
        if (zTs is None) == (x0s is None):
            raise ValueError("pass exactly one of zTs / x0s")
        self.timings = {}
        prompts = self.prompt_set(for_prompt, edit_prompt)
        n = (zTs if x0s is None else x0s).shape[0]
        names = sample_names or [f"batch{i:03d}" for i in range(n)]
        with _Phase(self.timings, "invert", self.device):
            zTs = (self.shard_samples(self.invert, self._tensor(x0s)) if x0s is not None
                   else self._tensor(zTs))
        with _Phase(self.timings, "generate", self.device):
            zts = self.shard_samples(lambda z: self.generate(
                z, prompts, "null+(for-null)", 0, self.edit_t_idx), zTs)
        results = []
        for i in range(n):
            out_dir = os.path.join(cfg.result_folder, names[i])
            os.makedirs(out_dir, exist_ok=True)
            mask_i = (masks[i:i + 1] if masks is not None
                      and np.asarray(masks[i]).any() else None)
            with _Phase(self.timings, "basis", self.device):
                vT = self._resolve_basis_zt(zts[i:i + 1], prompts, mask_i, out_dir,
                                            semantic)
            with _Phase(self.timings, "strips", self.device):
                strips, z0_strips = self._render_strips_zt(zts[i:i + 1], prompts, vT,
                                                           out_dir)
            results.append({"zt": _host(zts[i:i + 1]), "vT": _host(vT),
                            "strips": strips, "z0_strips": z0_strips,
                            "out_dir": out_dir})
        with _Phase(self.timings, "io", self.device):
            self.flush_io()
        return results

"""T-LOCO on DeepFloyd-IF: the pixel-space cascade edit engine (port of
loco_edit_tpu/pipelines/deepfloyd.py).

Stage-1 64 px pixel-space editing with the 8-mode CFG combiner on the eps
half of the learned-sigma output, the squaredcos_cap_v2 linspace DDIM grid
with t_max 990, directions from prompt differences without a Jacobian
(direct_direction), from the prompt-delta Jacobian (delta_xt_via_grad) or
from the subspace iteration, DiffEdit masks from epsilon differences, the
masked-DiffEdit and SEGA ablation samplers, and the stage-2 upscaler hook
(pipelines/superres.py).

Randomness comes from named forks of the run's RngStream with the JAX
package's stream names ("xT", "if-probes-{rank}", "diffedit"), so a test can
hand the pipeline a stream that yields the JAX package's draws. With
`cfg.pixel_output` the stage-1 strip (pixel space already) and the stage-2
strip are each converted to uint8 on the device before the copy to the
host; the stage-2 upscaler reads the float stage-1 strip. The mesh knobs
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
from loco_edit_tpu_torch.diffusion import LinspaceDDIM, ddim_generate, ddim_step
from loco_edit_tpu_torch.editing import (
    dual_subspace_iteration,
    load_directions,
    mask_cache_tag,
    normalize_rows,
    null_space_project,
    save_directions,
    subspace_iteration,
    x_space_guidance_strip,
)
from loco_edit_tpu_torch.editing.cfg import cfg_eps, perpendicular_component
from loco_edit_tpu_torch.editing.pullback import padded_probe_count
from loco_edit_tpu_torch.masks.diffedit import diffedit_mask
from loco_edit_tpu_torch.pipelines.common import EngineExec, _host, _Phase
from loco_edit_tpu_torch.utils.io import save_image_grid, to_uint8_pixels_device

DIRECT_MODES = ("(for-edit)-direct", "(edit-null)-direct",
                "proj_null[for-null](edit-null)-direct")


@dataclasses.dataclass
class IFEditConfig:
    for_steps: int = 100
    edit_t: float = 0.75
    t_max: int = 990
    guidance_scale: float = 7.0
    guidance_scale_edit: float = 4.0
    x_space_guidance_scale: float = 1.0
    x_space_guidance_edit_step: float = 1.0
    x_space_guidance_num_step: int = 4
    vis_num: int = 2
    pca_rank: int = 1
    pca_rank_null: int = 5
    null_space_projection: bool = True
    tilda_v_score_type: str = "(for-edit)-direct"
    jacobian: bool = False
    min_iter: int = 10
    max_iter: int = 50
    convergence_threshold: float = 1e-3
    probe_chunk: int | None = None
    mesh_probe: int = 0          # split the probes over this many ranks (0 = off)
    mesh_data: int = 0           # split strip frames / batch samples over ranks (0 = off)
    memory_bound: int = 0        # chunk strip denoise batches (0 = off)
    # return the stage-1 and stage-2 strips as uint8 pixels, converted on
    # the device
    pixel_output: bool = False
    result_folder: str = "./runs"
    save_images: bool = True


class IFEditPipeline(EngineExec):
    """Bound to unet_apply(x, t, context) -> (B, H, W, 2C) with learned-sigma
    channels, a prompt encoder str -> (1, seq, dim) T5 states and, for the
    stage-2 hook, superres(images, prompt) -> upscaled images; all on
    `device`."""

    def __init__(self, unet_apply, prompt_encoder, cfg: IFEditConfig, rng: RngStream,
                 sample_shape=(64, 64, 3), superres=None,
                 scheduler: LinspaceDDIM | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rng = rng
        self.sample_shape = tuple(sample_shape)
        c = sample_shape[-1]
        # IF predicts [eps | sigma]: the CFG combiner works on the eps half
        self.unet_apply = lambda x, t, ctx: unet_apply(x, t, ctx)[..., :c]
        self.prompt_encoder = prompt_encoder
        self.superres = superres
        # IF checkpoints are trained on squaredcos_cap_v2 (1000 entries)
        self.scheduler = scheduler or LinspaceDDIM(
            t_max=cfg.t_max, noise_schedule="squaredcos_cap_v2")
        self.gen_grid = self.scheduler.generation_grid(cfg.for_steps)
        self.edit_t_idx = self.scheduler.nearest_step_index(cfg.for_steps, cfg.edit_t)
        self._emb_cache: dict[str, torch.Tensor] = {}
        # seconds per phase of the last run_edit_null_space_projection_xt call
        self.timings: dict[str, float] = {}
        os.makedirs(cfg.result_folder, exist_ok=True)

    def emb(self, prompt: str) -> torch.Tensor:
        if prompt not in self._emb_cache:
            self._emb_cache[prompt] = self._tensor(self.prompt_encoder(prompt))
        return self._emb_cache[prompt]

    def prompt_set(self, for_prompt: str, edit_prompt: str = "") -> dict:
        return {"for": self.emb(for_prompt), "edit": self.emb(edit_prompt),
                "null": self.emb("")}

    def _eps_fn(self, prompts: dict, mode: str) -> Callable:
        enabled = self.cfg.guidance_scale > 1.0
        return lambda x, t: cfg_eps(
            self.unet_apply, x, t, prompts, mode, self.cfg.guidance_scale,
            self.cfg.guidance_scale_edit, enabled=enabled)

    @torch.no_grad()
    def forward_steps(self, xt, prompts: dict, mode: str, start_idx: int = 0,
                      end_idx: int | None = None) -> torch.Tensor:
        """DDIM under `mode` over generation steps [start_idx, end_idx)."""
        end = None if end_idx in (None, -1) else end_idx
        return ddim_generate(self._eps_fn(prompts, mode), self._tensor(xt),
                             self.gen_grid, start_idx=start_idx, end_idx=end)

    @torch.no_grad()
    def masked_forward_steps(self, xt, prompts: dict, mask, start_idx: int = 0,
                             end_idx: int | None = None) -> torch.Tensor:
        """The DiffEdit ablation sampler: each step blends the edit-guided
        and for-guided DDIM updates through the mask."""
        end = len(self.gen_grid) if end_idx in (None, -1) else end_idx
        grid = self.gen_grid.slice(start_idx, end)
        f_for = self._eps_fn(prompts, "null+(for-null)")
        f_edit = self._eps_fn(prompts, "null+(edit-null)")
        x = self._tensor(xt)
        m = self._tensor(mask)
        for i in range(len(grid)):
            t, ab, ab_next = float(grid.t[i]), grid.alpha_bar[i], grid.alpha_bar_next[i]
            x_for, _ = ddim_step(x, f_for(x, t), ab, ab_next)
            x_edit, _ = ddim_step(x, f_edit(x, t), ab, ab_next)
            x = x_edit * m + x_for * (1 - m)
        return x

    # -- direction sources -----------------------------------------------------

    def pmp_fn(self, prompts: dict, mode: str) -> Callable:
        """f(x_t) = PMP(x_t) under `mode` at edit_t: the Jacobian target."""
        t = float(self.gen_grid.t[self.edit_t_idx])
        ab = float(self.gen_grid.alpha_bar[self.edit_t_idx])
        eps = self._eps_fn(prompts, mode)

        def f(x):
            return (x - eps(x, t) * np.sqrt(1.0 - ab)) / np.sqrt(ab)

        return f

    @torch.no_grad()
    def direct_direction(self, xt, prompts: dict, mode: str) -> torch.Tensor:
        """A direction without a Jacobian: an epsilon combination at x_t
        itself; unit norm, (1, d)."""
        t = float(self.gen_grid.t[self.edit_t_idx])
        x = self._tensor(xt)
        g = self.cfg.guidance_scale

        def e(m):
            return cfg_eps(self.unet_apply, x, t, prompts, m, g, enabled=True)

        if mode == "(for-edit)-direct":
            v = e("(for-edit)")
        elif mode == "(edit-null)-direct":
            v = -e("(edit-null)")
        elif mode == "proj_null[for-null](edit-null)-direct":
            v = -perpendicular_component(e("(edit-null)"), e("(for-null)"))
        else:
            raise ValueError(f"unknown direct mode {mode!r}; valid: {DIRECT_MODES}")
        v = v.reshape(1, -1).float()
        return v / torch.linalg.norm(v, dim=1, keepdim=True)

    def delta_xt_via_grad(self, xt, prompts: dict, mask, mode: str) -> torch.Tensor:
        """The prompt-delta Jacobian direction in pixel space: the gradient
        of <PMP under `mode` - PMP under null+(for-null), PMP under
        `mode`(x)>, masked; unit norm, (1, d)."""
        f_base = self.pmp_fn(prompts, "null+(for-null)")
        f_mode = self.pmp_fn(prompts, mode)
        mw = None if mask is None else self._tensor(mask)
        x = self._tensor(xt)
        with torch.no_grad():
            delta = f_mode(x) - f_base(x)
            if mw is not None:
                delta = delta * mw

        def g(xx):
            y = f_mode(xx)
            if mw is not None:
                y = y * mw
            return (delta * y).sum()

        v = torch.func.grad(g)(x).reshape(1, -1).float()
        return v / torch.linalg.norm(v, dim=1, keepdim=True)

    def extract_basis(self, xt, prompts: dict, mode: str, mask, rank: int):
        cfg = self.cfg
        m = None if mask is None else self._tensor(mask)
        return subspace_iteration(
            self.pmp_fn(prompts, mode), self._tensor(xt),
            self.rng.fork(f"if-probes-{rank}"), rank=rank, mask=m,
            min_iter=cfg.min_iter, max_iter=cfg.max_iter,
            tol=cfg.convergence_threshold, probe_chunk=cfg.probe_chunk,
            probe_mesh=self._probe_sharding())

    def extract_dual_basis(self, xt, prompts: dict, mode: str, mask, rank: int,
                           rank_null: int):
        """Mask + complement-mask bases of the same PMP Jacobian in one fused
        iteration; probe streams as the two solo calls'."""
        cfg = self.cfg
        mw = self._tensor(mask)
        return dual_subspace_iteration(
            self.pmp_fn(prompts, mode), self._tensor(xt),
            self.rng.fork(f"if-probes-{rank}"), self.rng.fork(f"if-probes-{rank_null}"),
            rank_a=rank, rank_b=rank_null, mask_a=mw, mask_b=(mw == 0).float(),
            min_iter=cfg.min_iter, max_iter=cfg.max_iter,
            tol=cfg.convergence_threshold, probe_chunk=cfg.probe_chunk,
            probe_mesh=self._probe_sharding())

    def diffedit_mask(self, x0, prompts: dict) -> np.ndarray:
        """The DiffEdit mask of x0 between the for- and edit-guided eps,
        (1, H, W, 1) bool."""
        m = diffedit_mask(self._eps_fn(prompts, "null+(for-null)"),
                          self._eps_fn(prompts, "null+(edit-null)"), self._tensor(x0),
                          self.scheduler.schedule.alphas_cumprod,
                          self.rng.fork("diffedit"))
        return _host(m)

    # -- experiments --------------------------------------------------------------

    def run_edit_null_space_projection_xt(
            self, for_prompt: str, edit_prompt: str = "", xT=None, mask=None,
            sample_name: str = "sample", semantic: bool = True,
            ablation: str | None = None, vT_path: str | None = None) -> dict:
        """The pixel-space IF edit. semantic=True takes the direct or
        Jacobian prompt direction, else the subspace iteration; ablation
        'diffedit' runs the masked sampler and 'sega' the edit-guided tail
        denoise, both instead of the basis. vT_path loads a saved direction
        file instead of computing it. Returns numpy xt, vT, the strip
        ("image": stage 2's when the upscaler is bound, "stage1" always) and
        out_dir; with an ablation, {"image": ...}."""
        cfg = self.cfg
        self.timings = {}
        prompts = self.prompt_set(for_prompt, edit_prompt)
        h, w, c = self.sample_shape
        xT = (self.rng.fork("xT").normal((1, h, w, c), device=self.device)
              if xT is None else self._tensor(xT))
        out_dir = os.path.join(cfg.result_folder, sample_name)
        os.makedirs(out_dir, exist_ok=True)

        with _Phase(self.timings, "generate", self.device):
            xt = self.forward_steps(xT, prompts, "null+(for-null)", 0, self.edit_t_idx)

        if ablation in ("sega", "diffedit"):
            with _Phase(self.timings, "strips", self.device):
                if ablation == "sega":
                    x0 = self.forward_steps(xt, prompts, "null+(for-null)+(edit-null)",
                                            self.edit_t_idx, None)
                else:
                    if mask is None:
                        raise ValueError("diffedit ablation needs a mask")
                    x0 = self.masked_forward_steps(xt, prompts, mask,
                                                   self.edit_t_idx, None)
                img = _host(x0)
            if cfg.save_images and is_main_process():
                save_image_grid(img, os.path.join(out_dir, f"{ablation}.png"))
            return {"image": img}

        with _Phase(self.timings, "basis", self.device):
            if vT_path:
                vT = self._tensor(load_directions(vT_path)[0])
            else:
                vT = self._resolve_basis_xt(xt, prompts, mask, out_dir, semantic)

        with _Phase(self.timings, "strips", self.device):
            strip = x_space_guidance_strip(
                xt, vT[0], scale=cfg.x_space_guidance_scale,
                edit_step=cfg.x_space_guidance_edit_step,
                num_steps=cfg.x_space_guidance_num_step, vis_num=cfg.vis_num)
            x0 = self.run_batched(
                lambda ss: self.forward_steps(ss, prompts, "null+(for-null)",
                                              self.edit_t_idx, None), strip)
            stage1 = img = _host(to_uint8_pixels_device(x0) if cfg.pixel_output else x0)
        if cfg.save_images:
            self._submit_io(save_image_grid, img,
                            os.path.join(out_dir, "edit-if-stage1.png"))
        if self.superres is not None:
            with _Phase(self.timings, "superres", self.device):
                up = self.superres(x0, for_prompt)
                img = _host(to_uint8_pixels_device(up) if cfg.pixel_output else up)
            if cfg.save_images:
                self._submit_io(save_image_grid, img,
                                os.path.join(out_dir, "edit-if-stage2.png"))
        with _Phase(self.timings, "io", self.device):
            self.flush_io()
        return {"xt": _host(xt), "vT": _host(vT), "image": img, "stage1": stage1,
                "out_dir": out_dir}

    def _save_vT(self, path: str, vT: torch.Tensor):
        self._submit_io(save_directions, path, _host(vT), edit_t=self.cfg.edit_t)

    def _resolve_basis_xt(self, xt, prompts: dict, mask, out_dir: str,
                          semantic: bool) -> torch.Tensor:
        """Disk-cached basis with all-or-nothing file semantics: the modify
        (+ null) files of this rank, edit_t and mask are reloaded when all
        exist; fresh non-semantic modify + null fuse into one dual iteration
        when their probe counts agree; semantic directions are direct or
        Jacobian (cfg.jacobian) and never cached."""
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
            if cfg.jacobian:
                vT_modify = self.delta_xt_via_grad(xt, prompts, mask,
                                                   cfg.tilda_v_score_type)
            else:
                vT_modify = self.direct_direction(xt, prompts, cfg.tilda_v_score_type)
        elif use_dual:
            t0 = time.time()
            basis, nbasis = self.extract_dual_basis(
                xt, prompts, "null+(for-null)", mask, cfg.pca_rank, cfg.pca_rank_null)
            vT_modify, vT_null_pre = basis.vT, nbasis.vT
            print(f"power method runtime == {time.time() - t0:.2f}s "
                  f"({basis.iters} iters, fused modify+null)")
            self._save_vT(modify_path, vT_modify)
            self._save_vT(null_path, vT_null_pre)
        else:
            t0 = time.time()
            vT_modify = self.extract_basis(xt, prompts, "null+(for-null)", mask,
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
                vT_null = self.extract_basis(xt, prompts, "null+(for-null)",
                                             ~np.asarray(mask, bool),
                                             cfg.pca_rank_null).vT
                if not semantic:
                    self._save_vT(null_path, vT_null)
            vT = null_space_project(vT_modify, vT_null, cfg.pca_rank_null)
        else:
            vT = normalize_rows(vT_modify)
        self._submit_io(save_directions, os.path.join(basis_dir, "vT.npz"), _host(vT))
        return vT

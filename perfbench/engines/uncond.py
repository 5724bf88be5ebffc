"""The unconditional (ADM) edit engine under the benchmark: how set-up
builds the served pipeline from a configuration file, what an edit costs
in operations, and how the plain reference judges a served edit.

The served edit (UncondEditPipeline.run_edit_null_space_projection behind
/edit): x_T from the request's seed, DDIM generation to edit_t, the
masked-Jacobian bases of the mask and its complement (a fixed number of
sweeps; one fused iteration when their ranks agree, two otherwise),
null-space projection, +/- walks of every component, and the
boosted denoise of all strips in one batch, as uint8 pixels.

The judgement of one served edit, against the plain float32 reference
(reference/adm.py, reference/loco.py) on the same weights, x_T, mask and
draws:

- basis_gap: the program's projected directions (the edit's direction
  files, pc_*-vT.npz) against the reference's own basis, computed from its
  own x_{edit_t} with the same probes: 1 - the mean squared cosine of the
  principal angles between their spans;
- strips_gap: every served strip frame against the reference's frames
  (its own generation to edit_t, the program's directions walked by the
  configuration's offsets in the served order, its own boosted denoise
  with the same noise), relative L2 on the [-1, 1] scale. The strip stage
  follows the program's directions, since a basis is defined up to
  rotations within its span; basis_gap checks that stage by itself, and
  each strip's centre frame, which no direction moves, checks the
  generation and the denoise alone.
- answer_faults: strips whose shape, dtype or component count is not the
  configuration's, or a response without null-space projection.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from perfbench import flops as fl
from perfbench import inputs
from perfbench.engines import common
from perfbench.engines.common import reference_weights
from perfbench.reference import adm as ref_adm
from perfbench.reference import loco


class Engine:
    def __init__(self, config: dict, *, device: str, weight_seed: int, server_seed: int,
                 prompt_seed: int):
        self.config = config
        self.device = torch.device(device)
        self.weight_seed = weight_seed
        self.server_seed = server_seed
        e = config["edit"]
        m = config["model"]
        self.hw = (m["image_size"], m["image_size"])
        self.mask_hw = self.hw
        self.shape = (1, m["image_size"], m["image_size"], m["in_channels"])
        self.grid = loco.Grid(e["for_steps"])
        self.t_idx = self.grid.index_of(e["edit_t"])
        self.n_pc = e["pca_rank"]
        self.offsets = loco.walk_offsets(e["x_space_guidance_scale"],
                                         e["x_space_guidance_edit_step"],
                                         e["x_space_guidance_num_step"], e["vis_num"])
        self.frames = self.n_pc * len(self.offsets)
        with torch.device("meta"):
            meta = ref_adm.build(m, "meta")
            f1 = fl.forward_flops(meta, torch.empty(self.shape), 500.0)
        probes = e["pca_rank"] + e["pca_rank_null"]
        strip_steps = len(self.grid) - self.t_idx
        self.flops = (f1 * (self.t_idx + strip_steps * self.frames)
                      + fl.basis_flops(f1, e["sweeps"], probes))
        self.svc = None

    # -- set-up -------------------------------------------------------------------

    def argv(self, result_folder: str) -> list[str]:
        e = self.config["edit"]
        return ["--model_name", self.config["model_name"], "--dataset_name", "Random",
                "--dtype", self.config["dtype"], "--device", self.device.type,
                "--for_steps", str(e["for_steps"]), "--inv_steps", str(e["for_steps"]),
                "--edit_t", str(e["edit_t"]),
                "--performance_boosting_t", str(e["performance_boosting_t"]),
                "--x_space_guidance_scale", str(e["x_space_guidance_scale"]),
                "--x_space_guidance_num_step", str(e["x_space_guidance_num_step"]),
                "--x_space_guidance_edit_step", str(e["x_space_guidance_edit_step"]),
                "--vis_num", str(e["vis_num"]), "--pca_rank", str(e["pca_rank"]),
                "--pca_rank_null", str(e["pca_rank_null"]),
                "--null_space_projection", "true", "--seed", str(self.server_seed),
                "--result_folder", result_folder]

    def build(self, result_folder: str):
        """The served pipeline with the benchmark's weights and fixed sweeps."""
        from loco_edit_tpu_torch.cli.args import parse_args, preset
        from loco_edit_tpu_torch.core.cache import enable_compile_cache
        from loco_edit_tpu_torch.serve import EditService

        enable_compile_cache()
        args = preset(parse_args(self.argv(result_folder)))
        self.svc = EditService(args)
        cfg = self.svc.pipe.cfg
        cfg.min_iter = cfg.max_iter = self.config["edit"]["sweeps"]
        cfg.convergence_threshold = 0.0
        model = self.svc.denoiser.meta["model"]
        n = sum(p.numel() for p in model.parameters())
        if n != self.config["model"]["parameters"]:
            raise ValueError(f"the served model has {n} parameters, the configuration "
                             f"{self.config['model']['parameters']}")
        inputs.load_weights(model, self.weight_seed, inputs.served_dtype(self.config))
        self.result_folder = cfg.result_folder
        return self.svc

    def models(self) -> dict:
        return {"unet": self.svc.denoiser.meta["model"]}

    def release(self):
        self.svc = None

    # -- the reference ----------------------------------------------------------------

    def reference(self, quant=None):
        """The float32 reference model with the benchmark's weights (the same
        draws, in the served dtype, widened), on the device."""
        model = reference_weights(ref_adm.build(self.config["model"], "meta"),
                                  self.weight_seed, self.device, self.config)
        return model.set_quant(quant)

    def _mask(self, req) -> torch.Tensor:
        y0, y1, x0, x1 = req["mask_bbox"]
        m = torch.zeros(self.shape, device=self.device)
        m[:, y0:y1, x0:x1, :] = 1.0
        return m

    def generate(self, model, rec):
        xT = loco.Stream.root(int(rec.request["seed"])).normal(self.shape, self.device)
        return loco.denoise(model, xT, self.grid, 0, self.t_idx)

    def basis(self, model, xt, rec):
        e = self.config["edit"]
        root = loco.Stream.root(self.server_seed)
        d = xt.numel()
        mask = self._mask(rec.request)
        t = float(self.grid.t[self.t_idx])
        ab = self.grid.ab[self.t_idx]
        return loco.edit_basis(
            lambda x: loco.pmp(x, model(x, t), ab), xt, mask,
            loco.init_probes(root.fork(f"probes-r{e['pca_rank']}"), e["pca_rank"], d,
                             self.device),
            loco.init_probes(root.fork(f"probes-null-r{e['pca_rank_null']}"),
                             e["pca_rank_null"], d, self.device), e["sweeps"])

    @torch.no_grad()
    def strips(self, model, xt, vT, rec):
        """Every strip frame, in the served order (component by component,
        each strip's walk from its negative end), denoised with the served
        edit's boost noise."""
        e = self.config["edit"]
        frames = torch.cat([xt + float(o) * v.reshape(xt.shape)
                            for v in vT for o in self.offsets])
        stream = loco.Stream.root(self.server_seed).fork("boost-eta").at_step(
            rec.boost_index)
        out = loco.denoise(model, frames, self.grid, self.t_idx, len(self.grid),
                           eta=self.grid.boost_eta(e["performance_boosting_t"]),
                           stream=stream)
        return loco.to_uint8(out)

    def program_output(self, rec):
        """The served edit's frames (uint8), its directions (the edit's
        direction files) and the count of answer faults."""
        from perfbench.harness import decode_strips

        e = self.config["edit"]
        ans = rec.answer
        strips = decode_strips(ans)
        faults = int(not ans.get("null_space_projection"))
        want = (len(self.offsets),) + self.shape[1:]
        if sorted(strips) != list(range(self.n_pc)):
            faults += 1
        for s in strips.values():
            faults += int(s.dtype != np.uint8 or s.shape != want)
        if faults:
            return None, None, faults
        frames = np.concatenate([strips[pc] for pc in range(self.n_pc)])
        basis_dir = os.path.join(self.result_folder, rec.request["sample_name"], "basis",
                                 f"local_basis-{e['edit_t']}T")
        rows = [np.load(p)["vT"] for p in sorted(glob.glob(
            os.path.join(basis_dir, "pc_*-vT.npz")))]
        if len(rows) != self.n_pc:
            return None, None, 1
        vT = torch.as_tensor(np.concatenate(rows).reshape(self.n_pc, -1),
                             device=self.device, dtype=torch.float32)
        return torch.as_tensor(frames, device=self.device), vT, 0

    judge = common.judge

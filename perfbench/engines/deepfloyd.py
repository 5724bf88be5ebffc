"""The DeepFloyd-IF cascade edit engine under the benchmark: set-up of the
served pipeline from a configuration file, the operations an edit needs,
and the plain reference's judgement of a served edit.

The served edit (IFEditPipeline.run_edit_null_space_projection_xt behind
/edit with "semantic" false): x_T from the request's seed, CFG DDIM steps
of IF-I-M to edit_t, the fused masked-Jacobian bases of the CFG posterior
mean for the box mask and its complement (a fixed number of sweeps),
null-space projection, the walk of the first direction (3 frames), the
CFG DDIM steps to 0, then the IF-II-L upscale of the frames
(SuperResSampler) to 256 px, as uint8 pixels. The prompts' T5 states are
the benchmark's (perfbench/inputs.py::prompt_embedding), handed to both
stages and to the reference.

The judgement, against the plain float32 reference (reference/ifm.py,
reference/loco.py) on the same weights, x_T, states, mask and draws:
basis_gap (the program's projected directions, the edit's basis/vT.npz,
against the reference's own basis from its own x at edit_t with the same
probes), strips_gap (the 3 served 256 px frames against the reference's:
its own generation, the program's first direction walked, its own stage-1
steps and its own upscale with the same "sr-aug" / "sr-noise" draws at
the edit's call index), answer_faults; as in engines/lcm.py.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from perfbench import flops as fl
from perfbench import inputs
from perfbench.engines import common
from perfbench.engines.common import reference_weights
from perfbench.reference import ifm as ref_ifm
from perfbench.reference import loco


class Ops(float):
    """An edit's operations, with the stage-2 upscale's share as `superres`
    (read by metrics/superres_mfu.py)."""

    def __new__(cls, total: float, superres: float):
        self = super().__new__(cls, total)
        self.superres = superres
        return self


class Engine:
    def __init__(self, config: dict, *, device: str, weight_seed: int, server_seed: int,
                 prompt_seed: int):
        self.config = config
        self.device = torch.device(device)
        self.weight_seed = weight_seed
        self.server_seed = server_seed
        self.prompt_seed = prompt_seed
        e, s1, s2, sr = config["edit"], config["stage1"], config["stage2"], config["superres"]
        px = s1["sample_size"]
        self.shape = (1, px, px, 3)
        self.mask_hw = (px, px)
        self.ctx_shape = (config["context_tokens"], s1["encoder_hid_dim"])
        self.grid = ref_ifm.Grid(e["for_steps"], e["t_max"])
        self.t_idx = self.grid.index_of(e["edit_t"])
        self.offsets = loco.walk_offsets(e["x_space_guidance_scale"],
                                         e["x_space_guidance_edit_step"],
                                         e["x_space_guidance_num_step"], e["vis_num"])
        self.out = (len(self.offsets), s2["sample_size"], s2["sample_size"], 3)
        unet1, unet2 = ref_ifm.build(config, "meta")
        with torch.device("meta"):
            ctx = torch.empty((1,) + self.ctx_shape)
            f1 = fl.forward_flops(unet1, torch.empty(self.shape), 500.0, ctx)
            x2 = torch.empty((1,) + self.out[1:3] + (s2["in_channels"],))
            f2 = fl.forward_flops(unet2, x2, 500.0, ctx, float(sr["aug_level"]))
        n = len(self.offsets)
        probes = e["pca_rank"] + e["pca_rank_null"]
        # CFG stacks the two prompts on the batch: two forwards a step
        up = 2 * n * f2 * len(ref_ifm.Grid(sr["steps"], sr["t_max"]))
        self.flops = Ops(2 * f1 * (self.t_idx + n * (len(self.grid) - self.t_idx))
                         + fl.basis_flops(2 * f1, e["sweeps"], probes) + up, up)
        self.svc = None

    # -- set-up -------------------------------------------------------------------

    def argv(self, result_folder: str) -> list[str]:
        e, sr = self.config["edit"], self.config["superres"]
        return ["--model_name", self.config["model_name"], "--dataset_name", "Random",
                "--dtype", self.config["dtype"], "--device", self.device.type,
                "--for_steps", str(e["for_steps"]), "--edit_t", str(e["edit_t"]),
                "--guidance_scale", str(e["guidance_scale"]),
                "--guidance_scale_edit", str(e["guidance_scale"]),
                "--performance_boosting_t", "0",
                "--x_space_guidance_scale", str(e["x_space_guidance_scale"]),
                "--x_space_guidance_edit_step", str(e["x_space_guidance_edit_step"]),
                "--x_space_guidance_num_step", str(e["x_space_guidance_num_step"]),
                "--vis_num", str(e["vis_num"]), "--pca_rank", str(e["pca_rank"]),
                "--pca_rank_null", str(e["pca_rank_null"]),
                "--null_space_projection", "true",
                "--stage2_guidance_scale", str(sr["guidance_scale"]),
                "--seed", str(self.server_seed), "--result_folder", result_folder]

    def embed(self, prompt: str) -> torch.Tensor:
        return inputs.prompt_embedding(self.prompt_seed, prompt, self.ctx_shape, self.device)

    def build(self, result_folder: str):
        """The served pipeline with both U-Nets' parameter counts checked
        against the configuration before anything runs, then the
        benchmark's weights, states and fixed sweeps."""
        from loco_edit_tpu_torch.cli.args import parse_args, preset
        from loco_edit_tpu_torch.core.cache import enable_compile_cache
        from loco_edit_tpu_torch.serve import EditService

        enable_compile_cache()
        self.svc = EditService(preset(parse_args(self.argv(result_folder))))
        served = self.svc.bundle["models"]
        for name, key in (("unet", "stage1"), ("stage2", "stage2")):
            n = sum(p.numel() for p in served[name].parameters()) if name in served else 0
            if n != self.config[key]["parameters"]:
                raise ValueError(f"the served {key} U-Net has {n} parameters, the "
                                 f"configuration {self.config[key]['parameters']}")
        pipe, sr = self.svc.pipe, self.config["superres"]
        steps = len(ref_ifm.Grid(sr["steps"], sr["t_max"]))
        if (len(pipe.superres.grid), pipe.superres.aug_level) != (steps, sr["aug_level"]):
            raise ValueError(f"the upscaler runs {len(pipe.superres.grid)} steps at aug "
                             f"level {pipe.superres.aug_level}, the configuration "
                             f"{steps} at {sr['aug_level']}")
        cfg = pipe.cfg
        cfg.min_iter = cfg.max_iter = self.config["edit"]["sweeps"]
        cfg.convergence_threshold = 0.0
        for i, model in enumerate(self.models().values()):
            inputs.load_weights(model, self.weight_seed + i, inputs.served_dtype(self.config))
        pipe.prompt_encoder = pipe.superres.prompt_encoder = self.embed
        self.result_folder = cfg.result_folder
        return self.svc

    def models(self) -> dict:
        m = self.svc.bundle["models"]
        return {"unet": m["unet"], "stage2": m["stage2"]}

    def release(self):
        self.svc = None

    # -- the reference ----------------------------------------------------------------

    def reference(self, quant=None):
        return tuple(reference_weights(m, self.weight_seed + i, self.device,
                                       self.config).set_quant(quant)
                     for i, m in enumerate(ref_ifm.build(self.config, "meta")))

    def _eps(self, models, prompt):
        ctx_for, ctx_null = self.embed(prompt), self.embed("")
        g = self.config["edit"]["guidance_scale"]
        return lambda x, t: ref_ifm.cfg_eps(models[0], x, t, ctx_for, ctx_null, g)

    def generate(self, models, rec):
        xT = loco.Stream.root(int(rec.request["seed"])).normal(self.shape, self.device)
        return loco.denoise(self._eps(models, rec.request["for_prompt"]), xT, self.grid,
                            0, self.t_idx)

    def basis(self, models, xt, rec):
        e = self.config["edit"]
        root = loco.Stream.root(self.server_seed)
        d = xt.numel()
        y0, y1, x0, x1 = rec.request["mask_bbox"]
        mask = torch.zeros(self.shape, device=self.device)
        mask[:, y0:y1, x0:x1, :] = 1.0
        eps = self._eps(models, rec.request["for_prompt"])
        t, ab = float(self.grid.t[self.t_idx]), self.grid.ab[self.t_idx]
        return loco.edit_basis(
            lambda x: loco.pmp(x, eps(x, t), ab), xt, mask,
            loco.init_probes(root.fork(f"if-probes-{e['pca_rank']}"), e["pca_rank"], d,
                             self.device),
            loco.init_probes(root.fork(f"if-probes-{e['pca_rank_null']}"),
                             e["pca_rank_null"], d, self.device), e["sweeps"])

    @torch.no_grad()
    def strips(self, models, xt, vT, rec):
        """The 3 frames walked along the first direction, denoised by stage
        1 and upscaled by stage 2 as the edit's call of the upscaler."""
        sr, prompt = self.config["superres"], rec.request["for_prompt"]
        frames = torch.cat([xt + float(o) * vT[0].reshape(xt.shape) for o in self.offsets])
        x0 = loco.denoise(self._eps(models, prompt), frames, self.grid, self.t_idx,
                          len(self.grid))
        up = ref_ifm.superres(models[1], x0, self.embed(prompt), self.embed(""),
                              out_size=self.out[1], steps=sr["steps"],
                              scale=sr["guidance_scale"], aug_level=sr["aug_level"],
                              root=loco.Stream.root(self.server_seed),
                              call=rec.boost_index, t_max=sr["t_max"])
        return loco.to_uint8(up)

    def program_output(self, rec):
        from perfbench.harness import decode_strips

        ans = rec.answer
        strips = decode_strips(ans)
        faults = int(not ans.get("null_space_projection")) + int(sorted(strips) != [0])
        faults += sum(int(s.dtype != np.uint8 or s.shape != self.out) for s in strips.values())
        path = os.path.join(self.result_folder, rec.request["sample_name"], "basis", "vT.npz")
        if faults or not os.path.exists(path):
            return None, None, faults + int(not os.path.exists(path))
        vT = torch.as_tensor(np.load(path)["vT"], device=self.device,
                             dtype=torch.float32).reshape(self.config["edit"]["pca_rank"], -1)
        return torch.as_tensor(np.array(strips[0]), device=self.device), vT, 0

    judge = common.judge

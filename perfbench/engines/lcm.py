"""The LCM Dreamshaper v7 edit engine under the benchmark: set-up of the
served pipeline from a configuration file, the operations an edit needs,
and the plain reference's judgement of a served edit.

The served edit (LCMEditPipeline.run_edit_null_space_projection_zt behind
/edit with "semantic" false): z_T from the request's seed, two LCM steps to
edit_t_idx 2 under the guidance embedding, the fused masked-Jacobian bases
of decode(denoised(z)) through the U-Net and the 512 px VAE decoder for the
box mask and its complement (a fixed number of sweeps), null-space
projection, the walk of the first direction (3 frames), two LCM steps and
one decode, as uint8 pixels. The prompt's embedding is the benchmark's
(perfbench/inputs.py::prompt_embedding), handed to both sides.

The judgement, against the plain float32 reference (reference/sd.py,
reference/lcm.py) on the same weights, z_T, embedding, mask and draws:
basis_gap (the program's projected directions, the edit's basis/vT.npz,
against the reference's own basis from its own z at edit_t_idx with the
same probes), strips_gap (every served frame against the reference's: its
own generation, the program's first direction walked, its own steps and
decode with the same noise), answer_faults; as in engines/uncond.py.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from perfbench import flops as fl
from perfbench import inputs
from perfbench.engines import common
from perfbench.engines.common import reference_weights
from perfbench.reference import lcm as ref_lcm
from perfbench.reference import loco
from perfbench.reference import sd as ref_sd


class Engine:
    def __init__(self, config: dict, *, device: str, weight_seed: int, server_seed: int,
                 prompt_seed: int):
        self.config = config
        self.device = torch.device(device)
        self.weight_seed = weight_seed
        self.server_seed = server_seed
        self.prompt_seed = prompt_seed
        e, u, v = config["edit"], config["unet"], config["vae"]
        lat = u["sample_size"]
        self.latent = (1, lat, lat, u["in_channels"])
        px = lat * 2 ** (len(v["block_out_channels"]) - 1)
        self.mask_hw = (px, px)
        self.image = (1, px, px, v["out_channels"])
        self.ctx_shape = (config["context_tokens"], u["cross_attention_dim"])
        self.grid = ref_lcm.Grid(e["num_inference_steps"])
        self.t_idx = e["edit_t_idx"]
        self.w = e["guidance_scale"] - 1.0
        self.offsets = loco.walk_offsets(e["x_space_guidance_scale"], 1.0,
                                         e["x_space_guidance_num_step"], e["vis_num"])
        unet, dec = ref_sd.build(config, "meta")
        with torch.device("meta"):
            ctx = torch.empty((1,) + self.ctx_shape)
            fu = fl.forward_flops(unet, torch.empty(self.latent), 500.0, ctx, self.w)
            fd = fl.forward_flops(dec, torch.empty(self.latent))
        n = len(self.offsets)
        strip = (len(self.grid) - self.t_idx) * n * fu + n * fd
        probes = e["pca_rank"] + e["pca_rank_null"]
        self.flops = (self.t_idx * fu + fl.basis_flops(fu + fd, e["sweeps"], probes)
                            + strip)
        self.svc = None

    # -- set-up -------------------------------------------------------------------

    def argv(self, result_folder: str) -> list[str]:
        e = self.config["edit"]
        return ["--model_name", self.config["model_name"], "--dataset_name", "Random",
                "--dtype", self.config["dtype"], "--device", self.device.type,
                "--guidance_scale", str(e["guidance_scale"]),
                "--num_inference_steps", str(e["num_inference_steps"]),
                "--edit_t_idx", str(e["edit_t_idx"]),
                "--x_space_guidance_scale", str(e["x_space_guidance_scale"]),
                "--x_space_guidance_num_step", str(e["x_space_guidance_num_step"]),
                "--pca_rank", str(e["pca_rank"]), "--pca_rank_null", str(e["pca_rank_null"]),
                "--non_semantic", "true", "--null_space_projection", "true",
                "--vis_num", str(e["vis_num"]), "--use_yh_custom_scheduler", "false",
                "--seed", str(self.server_seed), "--result_folder", result_folder]

    def embed(self, prompt: str) -> torch.Tensor:
        return inputs.prompt_embedding(self.prompt_seed, prompt, self.ctx_shape, self.device)

    def build(self, result_folder: str):
        from loco_edit_tpu_torch.cli.args import parse_args, preset
        from loco_edit_tpu_torch.core.cache import enable_compile_cache
        from loco_edit_tpu_torch.serve import EditService

        enable_compile_cache()
        self.svc = EditService(preset(parse_args(self.argv(result_folder))))
        cfg = self.svc.pipe.cfg
        cfg.min_iter = cfg.max_iter = self.config["edit"]["sweeps"]
        models = self.models()
        for name, key in (("unet", "unet"), ("decoder", "vae")):
            n = sum(p.numel() for p in models[name].parameters())
            if n != self.config[key]["parameters"]:
                raise ValueError(f"the served {name} has {n} parameters, the "
                                 f"configuration {self.config[key]['parameters']}")
            inputs.load_weights(models[name], self.weight_seed + (name == "decoder"),
                                 inputs.served_dtype(self.config))
        self.svc.pipe.prompt_encoder = self.embed
        self.result_folder = cfg.result_folder
        return self.svc

    def models(self) -> dict:
        m = self.svc.bundle["models"]
        return {"unet": m["unet"], "decoder": m["decoder"]}

    def release(self):
        self.svc = None

    # -- the reference ----------------------------------------------------------------

    def reference(self, quant=None):
        unet, dec = ref_sd.build(self.config, "meta")
        unet = reference_weights(unet, self.weight_seed, self.device, self.config)
        dec = reference_weights(dec, self.weight_seed + 1, self.device, self.config)
        return unet.set_quant(quant), dec.set_quant(quant)

    def _noise(self, rec, phase: int) -> loco.Stream:
        """The k-th edit's inter-step noise stream: its generation's (phase 0)
        or its strip's (phase 1); each edit steps the sampler twice."""
        return loco.Stream.root(self.server_seed).fork("lcm-noise").at_step(
            2 * rec.boost_index + phase)

    def _eps(self, models, prompt):
        unet = models[0]
        ctx = self.embed(prompt)
        return lambda z, t: unet(z, t, ctx, self.w)

    def generate(self, models, rec):
        zT = loco.Stream.root(int(rec.request["seed"])).normal(self.latent, self.device)
        eps = self._eps(models, rec.request["for_prompt"])
        return ref_lcm.steps(eps, zT, self.grid, 0, self.t_idx, self._noise(rec, 0))[0]

    def basis(self, models, zt, rec):
        e = self.config["edit"]
        root = loco.Stream.root(self.server_seed)
        d = zt.numel()
        y0, y1, x0, x1 = rec.request["mask_bbox"]
        mask = torch.zeros(self.image, device=self.device)
        mask[:, y0:y1, x0:x1, :] = 1.0
        eps = self._eps(models, rec.request["for_prompt"])
        t = float(self.grid.t[self.t_idx])
        sf = self.config["vae"]["scaling_factor"]

        def f(z):
            return models[1](ref_lcm.denoised(z, eps(z, t), self.grid, self.t_idx) / sf)

        return loco.edit_basis(
            f, zt, mask,
            loco.init_probes(root.fork(f"lcm-probes-{e['pca_rank']}"), e["pca_rank"], d,
                             self.device),
            loco.init_probes(root.fork(f"lcm-probes-{e['pca_rank_null']}"),
                             e["pca_rank_null"], d, self.device), e["sweeps"])

    @torch.no_grad()
    def strips(self, models, zt, vT, rec):
        frames = torch.cat([zt + float(o) * vT[0].reshape(zt.shape) for o in self.offsets])
        eps = self._eps(models, rec.request["for_prompt"])
        den = ref_lcm.steps(eps, frames, self.grid, self.t_idx, len(self.grid),
                            self._noise(rec, 1))[1]
        return loco.to_uint8(models[1](den / self.config["vae"]["scaling_factor"]))

    def program_output(self, rec):
        from perfbench.harness import decode_strips

        ans = rec.answer
        strips = decode_strips(ans)
        want = (len(self.offsets),) + self.image[1:]
        faults = int(not ans.get("null_space_projection")) + int(sorted(strips) != [0])
        faults += sum(int(s.dtype != np.uint8 or s.shape != want) for s in strips.values())
        path = os.path.join(self.result_folder, rec.request["sample_name"], "basis", "vT.npz")
        if faults or not os.path.exists(path):
            return None, None, faults + int(not os.path.exists(path))
        vT = torch.as_tensor(np.load(path)["vT"], device=self.device,
                             dtype=torch.float32).reshape(self.config["edit"]["pca_rank"], -1)
        return torch.as_tensor(np.array(strips[0]), device=self.device), vT, 0

    judge = common.judge

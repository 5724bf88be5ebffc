"""What the ranks of tests/test_torch_mesh.py and test_torch_parallel.py run
(tests/_torch_dist_utils.py::run_ranks). No JAX here: the parent process
computes the JAX results and the JAX draws and passes them in the payload.
Each function returns numpy arrays and plain values."""

import numpy as np
import torch
import torch.distributed as dist

from loco_edit_tpu_torch.core.mesh import make_mesh, rank, world_size


def tiny_model(state_dict):
    from loco_edit_tpu_torch.models.adm import ADMUNet
    from loco_edit_tpu_torch.models.adm.presets import tiny_test_config

    m = ADMUNet(tiny_test_config())
    m.load_state_dict(state_dict)
    return m.requires_grad_(False).eval()


def _np(t):
    return t.detach().float().cpu().numpy()


# -- tests/test_torch_mesh.py ----------------------------------------------------

def train_step_run(p, mesh, steps: int):
    """`steps` train steps of the tiny ADM over `mesh` (None: one process)
    on the payload's global batch and noise; each data rank feeds its rows.
    Returns the metrics of each step and the full f32 parameters after."""
    from loco_edit_tpu_torch.core.mesh import DATA_AXIS
    from loco_edit_tpu_torch.diffusion.schedule import NoiseSchedule
    from loco_edit_tpu_torch.parallel.checks import replicated_params_checksum
    from loco_edit_tpu_torch.parallel.collectives import gather_cat
    from loco_edit_tpu_torch.training import TrainConfig, create_train_state, make_train_step

    model = tiny_model(p["state_dict"])
    cfg = TrainConfig(**p["cfg"])
    state = create_train_state(model, cfg, mesh=mesh, tp_min_size=p.get("tp_min_size", 1 << 16))
    step = make_train_step(model, cfg, NoiseSchedule.linear(), mesh=mesh)
    x0 = torch.from_numpy(p["x0"])
    if mesh is not None and mesh.shape.get(DATA_AXIS, 1) > 1:
        b = x0.shape[0] // mesh.shape[DATA_AXIS]
        lo = mesh.coordinate(DATA_AXIS) * b
        x0 = x0[lo:lo + b]
    out = []
    for i in range(steps):
        state, met = step(state, x0, torch.from_numpy(p["t"]).long(),
                          torch.from_numpy(p["w"]), noise=torch.from_numpy(p["noise"][i]))
        out.append({k: _np(v) for k, v in met.items()})
    tgroup = mesh.group("tp") if mesh is not None and mesh.shape.get("tp", 1) > 1 else None
    full = {k: gather_cat(v, state.tp_dims[k], tgroup) if k in state.tp_dims else v
            for k, v in state.params.items()}
    local_shapes = {k: tuple(v.shape) for k, v in state.params.items()}
    moment_shapes = {k: tuple(state.opt_state.adamw.state[v]["exp_avg"].shape)
                     for k, v in state.params.items()}
    return {"metrics": out, "params": {k: _np(v) for k, v in full.items()},
            "checksum": float(replicated_params_checksum(full)),
            "tp_dims": dict(state.tp_dims), "local_shapes": local_shapes,
            "moment_shapes": moment_shapes}


def loop_run(p, mesh, schedule=None):
    """run_training over the payload's toy batches (each rank its rows)."""
    from loco_edit_tpu_torch.core.mesh import DATA_AXIS
    from loco_edit_tpu_torch.parallel.checks import replicated_params_checksum
    from loco_edit_tpu_torch.training import TrainConfig
    from loco_edit_tpu_torch.training.loop import run_training

    model = tiny_model(p["state_dict"])
    n = 1 if mesh is None else mesh.shape[DATA_AXIS]
    r = 0 if mesh is None else mesh.coordinate(DATA_AXIS)

    def data():
        i = 0
        while True:
            g = p["batches"][i % len(p["batches"])]
            b = g.shape[0] // n
            yield torch.from_numpy(g[r * b:(r + 1) * b]), None
            i += 1

    state = run_training(model, data(), cfg=TrainConfig(lr=1e-3, microbatches=2),
                         schedule=schedule, mesh=mesh, total_steps=p["loop_steps"],
                         log_interval=100, ckpt_dir=None, loss_aware=True, seed=3,
                         device="cpu")
    return {"step": state.step, "checksum": float(replicated_params_checksum(state.params)),
            "params": {k: _np(v) for k, v in state.params.items()}}


def loop_table_run(p, mesh):
    """run_training over the payload's batches with the loss-aware resampler
    over p["loop_t_steps"] timesteps (2 losses of history each), its
    timesteps table[("t", step)] and its noise JAX's draws from the table
    (TableDraws in place of the loop's RngStream), so that it can be held to
    the JAX loop on the same draws. Returns the step and the parameters."""
    import dataclasses

    from loco_edit_tpu_torch.diffusion.schedule import NoiseSchedule
    from loco_edit_tpu_torch.training import loop as loop_mod
    from loco_edit_tpu_torch.training.resample import LossSecondMomentResampler

    @dataclasses.dataclass(frozen=True)
    class TableResampler(LossSecondMomentResampler):
        history_per_term: int = 2

        def sample(self, rng, batch, state):
            t = torch.from_numpy(rng.table[("t",) + rng.path]).long()
            return t, 1.0 / (self.num_timesteps * self._weights(state)[t])

    class TableRoot:
        @staticmethod
        def from_seed(seed):
            return TableDraws(p["loop_table"])

    saved = loop_mod.LossSecondMomentResampler, loop_mod.RngStream
    loop_mod.LossSecondMomentResampler, loop_mod.RngStream = TableResampler, TableRoot
    try:
        out = loop_run(p, mesh, schedule=NoiseSchedule.linear(timesteps=p["loop_t_steps"]))
    finally:
        loop_mod.LossSecondMomentResampler, loop_mod.RngStream = saved
    return out


def transport_cases():
    """gather_stack, halo_pad and its transpose over every rank, by the
    backend's own all_gather and send/recv and by the all_reduce fallback
    (collectives._native forced False): x is 1000 * rank + arange."""
    from loco_edit_tpu_torch.parallel import collectives

    g = make_mesh({"sp": world_size()}).group("sp")
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5) + 1000 * rank()
    out = {}
    for name in ("native", "fallback"):
        saved = collectives._native
        if name == "fallback":
            collectives._native = lambda t, group: False
        try:
            out[name] = {"gather": _np(collectives.gather_stack(x, g)),
                         "pad": _np(collectives.halo_pad(x, 2, 1, g)),
                         "unpad": _np(collectives.HaloUnpad.apply(x, 1, 1, g))}
        finally:
            collectives._native = saved
    return out


def sharded_gn(p):
    """GroupNorm of the payload's (B, C, H, W) x with its rows split over
    the ranks (GroupNormFn over a group: statistics pass, all-reduce, normalize
    pass, plain versions on the CPU): value, J v and v^T J gathered."""
    from loco_edit_tpu_torch.ops.groupnorm import GroupNormFn
    from loco_edit_tpu_torch.parallel.collectives import gather_replicated, take_shard

    mesh = make_mesh({"sp": world_size()})
    g = mesh.group("sp")
    x, v, u = (torch.from_numpy(p[k]) for k in ("gn_x", "gn_v", "gn_u"))
    scale, bias = torch.from_numpy(p["gn_scale"]), torch.from_numpy(p["gn_bias"])

    def f(z):
        y = GroupNormFn.apply(take_shard(z, 2, g), scale, bias, 32, 1e-5, g)
        return gather_replicated(y, 2, g)

    y, jv = torch.func.jvp(f, (x,), (v,))
    _, vjp = torch.func.vjp(f, x)
    # a batch of tangents, as the probe sweeps vmap them
    jvs = torch.func.vmap(lambda t: torch.func.jvp(f, (x,), (t,))[1])(torch.stack([v, 2 * v]))
    return {"y": _np(y), "jv": _np(jv), "vjp": _np(vjp(u)[0]), "jvs": _np(jvs)}


def mesh_cases(p):
    out = {"rank": rank(), "world": world_size(), "backend": dist.get_backend()}
    data_mesh = make_mesh()
    out["dp"] = train_step_run(p, data_mesh, steps=2)
    out["loop"] = loop_run(p, data_mesh)
    out["loop_jax"] = loop_table_run(p, data_mesh)
    out["transport"] = transport_cases()
    tp_p = dict(p, x0=p["tp_x0"], t=p["tp_t"], w=p["tp_w"], noise=p["tp_noise"],
                cfg=p["tp_cfg"], tp_min_size=1 << 10)
    out["tp"] = train_step_run(tp_p, make_mesh({"data": 2, "tp": 2}), steps=1)
    out["gn"] = sharded_gn(p)
    return out


# -- tests/test_torch_parallel.py --------------------------------------------------

class TableDraws:
    """An RngStream stand-in that yields given arrays: table[(path, step)]
    is the draw for the whole batch (a data-sharded share draws through a
    core/rng.py::RowWindow around it, which asks for the whole batch)."""

    def __init__(self, table, path=()):
        self.table, self.path = table, path

    def fork(self, name):
        return TableDraws(self.table, self.path + (name,))

    def at_step(self, step):
        return TableDraws(self.table, self.path + (step,))

    def normal(self, shape, *, device, dtype=torch.float32):
        full = torch.from_numpy(self.table[self.path]).to(device=device, dtype=dtype)
        assert tuple(full.shape) == tuple(shape), (self.path, full.shape, shape)
        return full


def _basis_np(b):
    return {"vT": _np(b.vT), "s": _np(b.s), "u": _np(b.u), "iters": b.iters}


def parallel_run(p, sharded: bool):
    """The probe-sharded bases, the data-sharded strips and the SP forward,
    DDIM loop and basis of the tiny ADM, with the meshes over every rank
    (sharded) or none (one process)."""
    from loco_edit_tpu_torch.core.mesh import PROBE_AXIS
    from loco_edit_tpu_torch.diffusion import LinspaceDDIM, ddim_generate
    from loco_edit_tpu_torch.diffusion.scheduler import pmp
    from loco_edit_tpu_torch.editing import pullback
    from loco_edit_tpu_torch.models.base import Denoiser
    from loco_edit_tpu_torch.parallel.sp import make_sp_mesh, sp_denoiser
    from loco_edit_tpu_torch.pipelines import UncondEditConfig, UncondEditPipeline

    model = tiny_model(p["state_dict"])
    T, AB = p["T"], p["AB"]
    out = {}
    x = torch.from_numpy(p["x"])
    f = lambda z: pmp(z, model(z, T), AB)   # noqa: E731
    pm = make_mesh({PROBE_AXIS: world_size()}) if sharded else None
    kw = dict(min_iter=2, max_iter=3, tol=0.0, probe_mesh=pm)
    out["solo"] = _basis_np(pullback.subspace_iteration(
        f, x, rank=p["solo_rank"], mask=torch.from_numpy(p["mask"]),
        v_init=torch.from_numpy(p["solo_v0"]), **kw))
    a, b = pullback.dual_subspace_iteration(
        f, x, rank_a=p["dual_rank"], rank_b=p["dual_rank"],
        mask_a=torch.from_numpy(p["mask"]), mask_b=torch.from_numpy(1 - p["mask"]),
        v_init=torch.from_numpy(p["dual_v0"]), **kw)
    out["dual"] = (_basis_np(a), _basis_np(b))

    # strips: the boosted tail over the frames, split over the data mesh
    den = Denoiser(eps_fn=lambda z, t: model(z, t), sample_shape=(32, 32, 3),
                   device=torch.device("cpu"))
    cfg = UncondEditConfig(for_steps=p["for_steps"], inv_steps=p["for_steps"],
                           edit_t=0.6, performance_boosting_t=0.4,
                           mesh_data=world_size() if sharded else 0,
                           result_folder=p["result_folder"], save_images=False)
    pipe = UncondEditPipeline(den, cfg, TableDraws(p["eta_table"]), device="cpu")
    frames = torch.from_numpy(p["frames"])
    run = frames if sharded else frames_padded(frames, p["pad_to"])
    out["strips"] = _np(pipe.generate_chunked(run, pipe.edit_t_idx, None, boost=True))

    # spatial parallelism: forward, DDIM loop, J v and basis at batch 1
    eps = (lambda z, t: model(z, t))
    sp_eps = sp_denoiser(eps, make_sp_mesh(world_size())) if sharded else eps
    xs = torch.from_numpy(p["sp_x"])
    out["sp_fwd"] = _np(sp_eps(xs, 431.0))
    grid = LinspaceDDIM().generation_grid(8)
    out["sp_ddim"] = _np(ddim_generate(sp_eps, xs[:1], grid))
    fsp = pullback.pmp_pullback_fn(sp_eps, AB, T)
    out["sp_jv"] = _np(torch.func.jvp(fsp, (torch.from_numpy(p["sp_x1"]),),
                                      (torch.from_numpy(p["sp_v"]),))[1])
    out["sp_basis"] = _basis_np(pullback.subspace_iteration(
        fsp, x, rank=p["solo_rank"], mask=torch.from_numpy(p["mask"]),
        v_init=torch.from_numpy(p["solo_v0"]), min_iter=2, max_iter=3, tol=0.0))
    return out


def frames_padded(frames, n):
    pad = n - frames.shape[0]
    return torch.cat([frames, frames.new_zeros((pad,) + tuple(frames.shape[1:]))])


def cli_edit(argv, iters=(2, 3)):
    """The uncond CLI's edit (python -m loco_edit_tpu_torch.cli.main argv)
    with the subspace iteration cut to `iters` (min, max) sweeps; returns
    the directions and strips."""
    from loco_edit_tpu_torch.cli import main

    build = main.build_uncond_pipeline

    def short(args):
        pipe, den, rng_ = build(args)
        pipe.cfg.min_iter, pipe.cfg.max_iter = iters
        return pipe, den, rng_

    main.build_uncond_pipeline = short
    try:
        r = main.main(argv)["edit"]
    finally:
        main.build_uncond_pipeline = build
    return {"vT": r["vT"], "strips": np.concatenate(list(r["strips"].values()))}


def parallel_cases(p):
    out = parallel_run(p, sharded=True)
    n = str(world_size())
    out["cli_mesh"] = cli_edit(p["cli_argv"] + ["--mesh_probe", n, "--mesh_data", n,
                                                "--result_folder", p["cli_dir"] + "_mesh"])
    out["cli_sp"] = cli_edit(p["cli_argv"] + ["--mesh_sp", n,
                                              "--result_folder", p["cli_dir"] + "_sp"])
    return out

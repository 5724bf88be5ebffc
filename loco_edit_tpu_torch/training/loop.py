"""The training loop: data -> step -> EMA -> log -> checkpoint (port of
loco_edit_tpu/training/loop.py).

TrainLoop parity (reference src/models/guided_diffusion/train_util.py:
22-272) with the JAX package's additions: loss-aware timestep resampling,
the DIFFUSION_TRAINING_TEST early-exit hook the reference kept for CI
(:164-166), and a checkpoint on SIGTERM (preemption). With `mesh`, data
parallel over torch.distributed ranks (the JAX loop's DATA_AXIS sharding):
each rank feeds its rows of the global batch, every rank draws the global
batch's timesteps, weights and noise from the same stream step and takes its
rows, the gradients are all-reduced (training/trainer.py), the loss-aware
resampler is updated from the all-gathered per-sample losses, so that every
rank holds the same state, and rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import os
import signal

import torch
from torch import nn

from loco_edit_tpu_torch.core.device import resolve_device
from loco_edit_tpu_torch.core.mesh import DATA_AXIS, initialize_distributed, is_main_process
from loco_edit_tpu_torch.core.rng import RngStream
from loco_edit_tpu_torch.diffusion.schedule import NoiseSchedule
from loco_edit_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from loco_edit_tpu_torch.training.resample import LossSecondMomentResampler, UniformSampler
from loco_edit_tpu_torch.training.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)
from loco_edit_tpu_torch.utils.logger import Logger


def run_training(model: nn.Module, data_iter, *, cfg: TrainConfig,
                 schedule: NoiseSchedule | None = None,
                 mesh=None,
                 total_steps: int = 10_000, log_interval: int = 100,
                 save_interval: int = 1000, ckpt_dir: str | None = None,
                 resume: bool = True, loss_aware: bool = False,
                 seed: int = 0, logger: Logger | None = None,
                 device: str | torch.device = "cuda"):
    """Train `model(x_t, t) -> eps` until the state reaches `total_steps`;
    returns the final TrainState. data_iter yields (x0 (B, H, W, C) in
    [-1, 1], labels); the model and batches go to `device` (the card unless
    "cpu"). With `resume`, starts from the newest checkpoint in ckpt_dir.
    mesh: a core/mesh.py Mesh with a data axis (make_mesh(), after
    initialize_distributed), or None for one process; data_iter then
    yields this rank's rows of each global batch (ShardedImageLoader
    shards its files by rank)."""
    dev = resolve_device(device)
    initialize_distributed(device=dev)
    model.to(dev)
    schedule = schedule or NoiseSchedule.linear()
    n_t = schedule.num_train_timesteps
    main_rank = is_main_process()
    n_data = 1 if mesh is None else mesh.shape.get(DATA_AXIS, 1)
    logger = logger or Logger(ckpt_dir if main_rank else None,
                              formats=("stdout", "json") if main_rank else ())
    sampler = (LossSecondMomentResampler(n_t) if loss_aware
               else UniformSampler(n_t))
    sampler_state = sampler.init_state()

    state = create_train_state(model, cfg, mesh=mesh)
    if resume and ckpt_dir and os.path.isdir(ckpt_dir):
        try:
            state = restore_checkpoint(ckpt_dir, state)
            print(f"resumed from step {state.step}")
        except FileNotFoundError:
            pass
    step_fn = make_train_step(model, cfg, schedule, mesh=mesh)

    stop = {"now": False}

    def _sigterm(signum, frame):
        stop["now"] = True

    old_handler = signal.signal(signal.SIGTERM, _sigterm)
    root = RngStream.from_seed(seed)
    try:
        while state.step < total_steps:
            x0, _labels = next(data_iter)
            x0 = torch.as_tensor(x0, device=dev)
            b = x0.shape[0] * n_data     # the global batch
            srng = root.at_step(state.step)
            if loss_aware:
                t, weights = sampler.sample(srng, b, sampler_state)
            else:
                t, weights = sampler.sample(srng, b)
            with logger.profile("step"):
                state, metrics = step_fn(state, x0, t.to(dev), weights.to(dev),
                                         srng.at_step(1))
            per = metrics["per_timestep_losses"].cpu()
            if loss_aware:
                sampler_state = sampler.update(sampler_state, t, per)
            logger.logkv_mean("loss", float(metrics["loss"]))
            logger.logkv_mean("grad_norm", float(metrics["grad_norm"]))
            # per-timestep-quartile losses (reference log_loss_dict,
            # train_util.py:296-301: loss_q0..loss_q3)
            for ti, li in zip(t.tolist(), per.tolist()):
                logger.logkv_mean(f"loss_q{int(4 * ti / n_t)}", li)
            s = state.step
            if s % log_interval == 0:
                logger.logkv("step", s)
                logger.dumpkvs()
            if ckpt_dir and main_rank and (s % save_interval == 0 or stop["now"]):
                save_checkpoint(ckpt_dir, state)
            if stop["now"]:
                print("SIGTERM: checkpoint saved, exiting training loop")
                break
            # CI early-exit hook (reference train_util.py:164-166)
            if os.environ.get("DIFFUSION_TRAINING_TEST", "") and s > 0:
                break
    finally:
        signal.signal(signal.SIGTERM, old_handler)
    return state

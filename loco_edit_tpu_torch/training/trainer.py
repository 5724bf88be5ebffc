"""Diffusion trainer (port of loco_edit_tpu/training/trainer.py).

The reference's TrainLoop step (guided_diffusion/train_util.py:22-272):
epsilon-MSE objective on q-sampled x_t, microbatch gradient accumulation
averaged over the chunks, AdamW with a linear learning-rate anneal and
optional global-norm clipping, EMA after the update, schedule-sampler
weights.

Master weights. The JAX package keeps f32 parameters and casts them to the
compute dtype at each op, so AdamW updates f32 weights with the gradient of
the bf16 computation cast up. The port's bf16 modules hold their conv and
dense weights in bf16, where most AdamW steps at lr 1e-4 would round away.
So the TrainState keeps f32 master parameters and the optimizer on them;
each step copies them into the model's weights (cast to their dtype), takes
the model's gradients as f32, accumulates them in f32 and updates the
masters. An f32 model computes exactly what the JAX package does.

Over a mesh (core/mesh.py), the counterpart of the JAX step jitted with
sharded inputs (training/loop.py, __graft_entry__.py):
  - data axis: each rank takes its rows of the global batch; the timesteps,
    weights and noise are the global batch's, sliced, so that the ranks
    together compute the one-process step. The f32 gradients are
    all-reduced (mean) before the norm and the clip, so every rank applies
    the same update; the loss is all-reduced and the per-sample losses
    all-gathered.
  - tp axis: the large kernels of the state (masters, EMA and with them
    the AdamW moments) are split along their output features
    (parallel/tp.py); each step gathers them for the forward and keeps
    only this rank's part of the gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from loco_edit_tpu_torch.diffusion.schedule import NoiseSchedule
from loco_edit_tpu_torch.core.mesh import DATA_AXIS
from loco_edit_tpu_torch.parallel.collectives import gather_cat, reduce_sum
from loco_edit_tpu_torch.parallel.tp import TP_AXIS, shard_params_tp


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 0.0
    ema_rate: float = 0.9999
    microbatches: int = 1            # gradient-accumulation chunks per step
    lr_anneal_steps: int = 0         # 0 = no anneal
    max_grad_norm: float = 0.0       # 0 = no clipping


class Optimizer:
    """optax's chain of the JAX package: clip_by_global_norm (when
    max_grad_norm > 0), then adamw with the learning rate annealed linearly
    to 0 over lr_anneal_steps updates (when > 0), over the f32 masters.

    torch.optim.AdamW is optax.adamw's map (decoupled decay, eps 1e-8 outside
    the square root). Clipping is by hand: clip_grad_norm_ divides by
    norm + 1e-6, optax by the norm itself."""

    def __init__(self, cfg: TrainConfig, params: Mapping[str, torch.Tensor]):
        self.cfg = cfg
        self.adamw = torch.optim.AdamW(list(params.values()), lr=cfg.lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=cfg.weight_decay)
        self.anneal = None
        if cfg.lr_anneal_steps > 0:
            n = cfg.lr_anneal_steps
            self.anneal = torch.optim.lr_scheduler.LambdaLR(
                self.adamw, lambda k: 1.0 - min(k, n) / n)

    def step(self, params: Mapping[str, torch.Tensor], grads: list[torch.Tensor],
             grad_norm: torch.Tensor) -> None:
        """One update of `params` in place from `grads` (f32, in params'
        order) whose global norm is grad_norm."""
        mx = self.cfg.max_grad_norm
        if mx > 0 and grad_norm >= mx:
            torch._foreach_mul_(grads, float(mx / grad_norm))
        for p, g in zip(params.values(), grads):
            p.grad = g
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        if self.anneal is not None:
            self.anneal.step()

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(),
                "anneal": None if self.anneal is None else self.anneal.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        if self.anneal is not None:
            self.anneal.load_state_dict(sd["anneal"])


def make_optimizer(cfg: TrainConfig, params: Mapping[str, torch.Tensor]) -> Optimizer:
    return Optimizer(cfg, params)


@dataclasses.dataclass
class TrainState:
    """step; f32 master params and EMA params by parameter name; the
    optimizer over the masters. tp_dims: name -> the dim a TP-sharded
    parameter is split along (this rank holds its part), empty without
    tensor parallelism."""

    step: int
    params: dict[str, torch.Tensor]
    opt_state: Optimizer
    ema_params: dict[str, torch.Tensor]
    tp_dims: dict[str, int] = dataclasses.field(default_factory=dict)


def create_train_state(params: Mapping[str, torch.Tensor] | nn.Module, cfg: TrainConfig,
                       mesh=None, tp_min_size: int = 1 << 16) -> TrainState:
    """params: name -> tensor (`dict(model.named_parameters())`) or the
    model; the state holds f32 copies on the same devices. With a mesh that
    has a tp axis, the large kernels are split over it (DTensor Shard,
    parallel/tp.py) and the state holds this rank's parts."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
    masters = {k: v.detach().float().clone() for k, v in named.items()}
    tp_dims = {}
    if mesh is not None and mesh.shape.get(TP_AXIS, 1) > 1:
        src = params if isinstance(params, nn.Module) else masters
        dts = shard_params_tp(src, mesh, min_size=tp_min_size)
        for k, dt in dts.items():
            shard = [pl for a, pl in zip(mesh.axis_names, dt.placements) if a == TP_AXIS][0]
            if shard.is_shard():
                tp_dims[k] = shard.dim
                masters[k] = dt.to_local().float().clone()
    return TrainState(step=0, params=masters, opt_state=make_optimizer(cfg, masters),
                      ema_params={k: v.detach().clone() for k, v in masters.items()},
                      tp_dims=tp_dims)


def q_sample(x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
             alphas_cumprod: torch.Tensor) -> torch.Tensor:
    """Forward process x_t = sqrt(abar_t) x0 + sqrt(1-abar_t) eps."""
    ab = alphas_cumprod[t].to(x0.dtype)
    ab = ab.reshape(ab.shape + (1,) * (x0.ndim - ab.ndim))
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def eps_mse_loss(apply_fn, x0, t, weights, noise, alphas_cumprod):
    """Per-batch weighted epsilon-MSE (the reference's default objective;
    apply_fn(x_t, t) -> eps, the learned-sigma channels not in the loss).
    Returns (loss, per_sample_losses)."""
    xt = q_sample(x0, t, noise, alphas_cumprod)
    eps_pred = apply_fn(xt, t)
    per = ((eps_pred - noise) ** 2).mean(dim=tuple(range(1, x0.ndim)))
    return (weights * per).mean(), per


def make_train_step(model: nn.Module, cfg: TrainConfig, schedule: NoiseSchedule,
                    mesh=None):
    """A train step (state, x0, t, weights, rng=None, noise=None) ->
    (state, metrics) for `model(x_t, t) -> eps`, the state updated in place.

    x0 (B, H, W, C), t (B,) integer timesteps and weights (B,) on the
    model's device; the batch is split into cfg.microbatches chunks, chunk i
    drawing its noise from rng.at_step(i) (an RngStream) unless `noise`
    (B, H, W, C) is given. The model runs in training mode during the step
    (dropout on where its config has it, as in the reference's TrainLoop)
    and is put back after. metrics: loss, grad_norm (of the averaged
    gradient, before clipping) and per_timestep_losses (B,), as tensors.

    With a mesh whose data axis has n ranks, x0 is this rank's b rows of a
    global batch of n * b; t, weights and noise (when given) are the global
    batch's, and the noise drawn otherwise is what the one-process step
    draws for the global batch. The metrics are the global batch's. With a
    tp axis the state comes from create_train_state(mesh=mesh)."""
    names = [k for k, _ in model.named_parameters()]
    model_params = [p for _, p in model.named_parameters()]
    trainable = [p.requires_grad for p in model_params]
    ab_host = torch.as_tensor(schedule.alphas_cumprod, dtype=torch.float32)
    axes = {} if mesh is None else mesh.shape
    dgroup = mesh.group(DATA_AXIS) if axes.get(DATA_AXIS, 1) > 1 else None
    tgroup = mesh.group(TP_AXIS) if axes.get(TP_AXIS, 1) > 1 else None
    n_data = axes.get(DATA_AXIS, 1)

    def full_masters(state: TrainState) -> list[torch.Tensor]:
        return [gather_cat(m, state.tp_dims[k], tgroup) if k in state.tp_dims else m
                for k, m in state.params.items()]

    def own_part(state: TrainState, k: str, g: torch.Tensor) -> torch.Tensor:
        if k not in state.tp_dims:
            return g
        dim = state.tp_dims[k]
        n = state.params[k].shape[dim]
        return g.narrow(dim, mesh.coordinate(TP_AXIS) * n, n).contiguous()

    def train_step(state: TrainState, x0, t, weights, rng=None, noise=None):
        n_micro = cfg.microbatches
        b = x0.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
        if list(state.params) != names:
            raise ValueError("the state's parameters are not the model's")
        if noise is None:
            gb = b * n_data
            noise = torch.cat([rng.at_step(i).normal((gb // n_micro,) + tuple(x0.shape[1:]),
                                                     device=x0.device, dtype=x0.dtype)
                               for i in range(n_micro)])
        if dgroup is not None:
            lo = mesh.coordinate(DATA_AXIS) * b
            t, weights, noise = t[lo:lo + b], weights[lo:lo + b], noise[lo:lo + b]
        ab = ab_host.to(x0.device)
        was_training = model.training
        model.train()
        model.requires_grad_(True)
        with torch.no_grad():
            for p, m in zip(model_params, full_masters(state)):
                p.copy_(m)
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in model_params]
        loss_sum, per_losses = 0.0, []
        try:
            for x0_m, t_m, w_m, n_m in zip(x0.chunk(n_micro), t.chunk(n_micro),
                                           weights.chunk(n_micro), noise.chunk(n_micro)):
                loss, per = eps_mse_loss(model, x0_m, t_m, w_m, n_m, ab)
                g = torch.autograd.grad(loss, model_params, allow_unused=True)
                for acc, gi in zip(grads, g):
                    if gi is not None:
                        acc.add_(gi.float())
                loss_sum = loss_sum + loss.detach()
                per_losses.append(per.detach())
        finally:
            for p, flag in zip(model_params, trainable):
                p.requires_grad_(flag)
            model.train(was_training)
        torch._foreach_div_(grads, n_micro)
        loss = loss_sum / n_micro
        per_losses = torch.cat(per_losses)
        if dgroup is not None:
            flat = reduce_sum(torch.cat([g.reshape(-1) for g in grads]), dgroup) / n_data
            grads = [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in grads]),
                                                  grads)]
            loss = reduce_sum(loss.reshape(1), dgroup)[0] / n_data
            per_losses = gather_cat(per_losses, 0, dgroup)
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        grads = [own_part(state, k, g) for k, g in zip(names, grads)]
        state.opt_state.step(state.params, grads, grad_norm)
        with torch.no_grad():
            ema = list(state.ema_params.values())
            torch._foreach_mul_(ema, cfg.ema_rate)
            torch._foreach_add_(ema, list(state.params.values()), alpha=1.0 - cfg.ema_rate)
        state.step += 1
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "per_timestep_losses": per_losses}
        return state, metrics

    return train_step

"""Timestep schedule samplers for training (port of
loco_edit_tpu/training/resample.py).

`UniformSampler` and the importance-sampling `LossSecondMomentResampler` of
the reference (guided_diffusion/resample.py:61,124). The resampler's state
is a per-timestep ring buffer of recent losses, a dict of CPU tensors;
`init_state`, `_weights` and `update` are deterministic and compute what the
JAX package's do. `sample` draws through a torch.Generator from an
RngStream (core/rng.py), on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class UniformSampler:
    num_timesteps: int

    def sample(self, rng, batch: int):
        t = torch.randint(0, self.num_timesteps, (batch,), generator=rng.generator())
        return t, torch.ones((batch,), dtype=torch.float32)

    def init_state(self):
        return ()

    def update(self, state, t, losses):
        return state


@dataclasses.dataclass(frozen=True)
class LossSecondMomentResampler:
    """Importance-sample timesteps in proportion to sqrt(E[loss^2]), with a
    uniform floor; the weights de-bias the estimate. Uniform until every
    timestep holds history_per_term losses (reference resample.py:124-154)."""

    num_timesteps: int
    history_per_term: int = 10
    uniform_prob: float = 0.001

    def init_state(self):
        return {
            "history": torch.zeros((self.num_timesteps, self.history_per_term),
                                   dtype=torch.float32),
            "counts": torch.zeros((self.num_timesteps,), dtype=torch.int32),
        }

    def _warmed_up(self, state) -> bool:
        return bool((state["counts"] >= self.history_per_term).all())

    def _weights(self, state) -> torch.Tensor:
        if self._warmed_up(state):
            w = torch.sqrt((state["history"] ** 2).mean(dim=-1))
        else:
            w = torch.ones((self.num_timesteps,), dtype=torch.float32)
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps

    def sample(self, rng, batch: int, state):
        p = self._weights(state)
        t = torch.multinomial(p, batch, replacement=True, generator=rng.generator())
        return t, 1.0 / (self.num_timesteps * p[t])

    def update(self, state, t, losses):
        """Insert the per-sample losses into the ring buffer at their
        timesteps, in batch order: append while a row is short of
        history_per_term, else drop its oldest. Returns the new state."""
        history, counts = state["history"].clone(), state["counts"].clone()
        full = self.history_per_term
        for ti, li in zip(torch.as_tensor(t).reshape(-1).tolist(),
                          torch.as_tensor(losses).detach().float().cpu().reshape(-1)):
            if counts[ti] >= full:
                history[ti] = torch.cat([history[ti, 1:], li.reshape(1)])
            else:
                history[ti, counts[ti]] = li
            counts[ti] = min(int(counts[ti]) + 1, full)
        return {"history": history, "counts": counts}

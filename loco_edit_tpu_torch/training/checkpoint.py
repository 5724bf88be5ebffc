"""Trainer checkpoints (port of loco_edit_tpu/training/checkpoint.py).

The JAX package writes orbax checkpoints; the port writes one `torch.save`
file per step, `ckpt_dir/<step>/state.pt`, with the reference's artifacts
(src/models/guided_diffusion/train_util.py:232-272): step, params (the f32
masters), optimizer state, EMA params, and an optional `extra` dict of plain
data. A checkpoint is written under a temporary name and renamed into place,
so a reader never sees half of one; the newest `max_to_keep` are kept.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import torch

from loco_edit_tpu_torch.training.trainer import TrainState

_FILE = "state.pt"


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.exists(os.path.join(ckpt_dir, d, _FILE)))


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    extra: dict[str, Any] | None = None,
                    max_to_keep: int = 3) -> None:
    step = int(state.step)
    payload = {"step": step, "params": state.params,
               "opt_state": state.opt_state.state_dict(),
               "ema_params": state.ema_params}
    if extra:
        payload["extra"] = extra
    final = os.path.join(ckpt_dir, str(step))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, template: TrainState,
                       step: int | None = None) -> TrainState:
    """Restore into `template` (its tensors keep their devices) and return
    it; raises FileNotFoundError when ckpt_dir holds no checkpoint."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    payload = torch.load(os.path.join(ckpt_dir, str(step), _FILE),
                         map_location="cpu", weights_only=True)
    with torch.no_grad():
        for name in ("params", "ema_params"):
            mine, saved = getattr(template, name), payload[name]
            if list(mine) != list(saved):
                raise ValueError(f"checkpoint {name} do not match the state's")
            for k, v in mine.items():
                v.copy_(saved[k])
    template.opt_state.load_state_dict(payload["opt_state"])
    template.step = int(payload["step"])
    return template

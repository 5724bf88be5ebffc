"""Timestep respacing: subsample a training schedule into fewer steps (a
numpy copy of loco_edit_tpu/diffusion/respace.py).

Counterpart of the reference's respace.py (src/models/guided_diffusion/
respace.py:7-128): `space_timesteps` supports per-section counts and the
"ddimN" stride syntax; `respaced_schedule` rebuilds the effective betas over
the kept timesteps (SpacedDiffusion's beta remapping) plus the kept->original
timestep map (_WrappedModel's rescaling)."""

from __future__ import annotations

import numpy as np

from loco_edit_tpu_torch.diffusion.schedule import NoiseSchedule


def space_timesteps(num_timesteps: int, section_counts) -> set[int]:
    """Which original timesteps to keep (reference respace.py:7-62)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with a stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    elif isinstance(section_counts, int):
        section_counts = [section_counts]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start = 0
    all_steps: list[int] = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        taken = []
        for _ in range(count):
            taken.append(start + round(cur))
            cur += stride
        all_steps += taken
        start += size
    return set(all_steps)


def respaced_schedule(schedule: NoiseSchedule, section_counts
                      ) -> tuple[NoiseSchedule, np.ndarray]:
    """(new NoiseSchedule over the kept steps, timestep_map kept->original).
    New betas satisfy 1 - b_new = abar_keep / abar_prev_keep
    (reference respace.py:63-115)."""
    keep = sorted(space_timesteps(schedule.num_train_timesteps, section_counts))
    ab = schedule.alphas_cumprod
    last = 1.0
    new_betas = []
    for t in keep:
        new_betas.append(1.0 - ab[t] / last)
        last = ab[t]
    new_betas = np.asarray(new_betas, np.float64)
    return (NoiseSchedule(betas=new_betas,
                          alphas_cumprod=np.cumprod(1.0 - new_betas)),
            np.asarray(keep, np.int64))

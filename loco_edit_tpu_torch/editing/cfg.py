"""Classifier-free-guidance epsilon combiner, all prompt-combination modes
(port of loco_edit_tpu/editing/cfg.py).

The prompt variants are stacked on the batch axis (one batched U-Net call)
and recombined per mode (g = guidance_scale, ge = guidance_scale_edit,
perp(a, b) = a - <a, b> / |b|^2 b):

  null+(for-null)                : e_n + g (e_f - e_n)
  null+(for-null)+(edit-null)    : e_n + g (e_f - e_n) + ge (e_e - e_n)
  null+(edit-null)               : e_n + g (e_e - e_n)
  (for-edit)                     : g (e_f - e_e)
  (for-null)                     : g (e_f - e_n)
  (edit-null)                    : g (e_e - e_n)
  edit-proj[for](edit)           : perp(e_e - e_n, e_f - e_n)
  null+for+edit-proj[for](edit)  : e_n + g (e_f - e_n) + ge perp(e_e - e_n, e_f - e_n)
"""

from __future__ import annotations

from typing import Callable

import torch

# eps_cond_fn(x, t, context) -> epsilon for a batch under one prompt context
CondEpsFn = Callable[[torch.Tensor, float, torch.Tensor], torch.Tensor]

CFG_MODES = (
    "null+(for-null)",
    "null+(for-null)+(edit-null)",
    "null+(edit-null)",
    "(for-edit)",
    "(for-null)",
    "(edit-null)",
    "edit-proj[for](edit)",
    "null+for+edit-proj[for](edit)",
)

# which prompt embeddings each mode stacks, in order
_STACKS: dict[str, tuple[str, ...]] = {
    "null+(for-null)": ("for", "null"),
    "null+(for-null)+(edit-null)": ("for", "edit", "null"),
    "null+(edit-null)": ("edit", "null"),
    "(for-edit)": ("for", "edit"),
    "(for-null)": ("for", "null"),
    "(edit-null)": ("edit", "null"),
    "edit-proj[for](edit)": ("for", "edit", "null"),
    "null+for+edit-proj[for](edit)": ("for", "edit", "null"),
}


def perpendicular_component(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Component of a orthogonal to b, per batch element."""
    dims = tuple(range(1, a.dim()))
    dot = (a * b).sum(dim=dims, keepdim=True)
    nrm = (b * b).sum(dim=dims, keepdim=True)
    return a - dot / torch.clamp(nrm, min=1e-12) * b


def cfg_eps(eps_cond_fn: CondEpsFn, x: torch.Tensor, t, prompts: dict,
            mode: str, guidance_scale: float, guidance_scale_edit: float = 0.0,
            enabled: bool = True) -> torch.Tensor:
    """Combined epsilon at x under `mode`.

    prompts: {'for': emb, 'edit': emb, 'null': emb} with emb (1, seq, dim).
    enabled=False is the no-CFG fallback: one pass under the 'for' prompt.
    """
    if mode not in _STACKS:
        raise ValueError(f"unknown CFG mode {mode!r}; valid: {CFG_MODES}")
    b = x.shape[0]

    def ctx_of(name):
        e = prompts[name]
        return e.expand((b,) + tuple(e.shape[-2:]))

    if not enabled:
        return eps_cond_fn(x, t, ctx_of("for"))

    names = _STACKS[mode]
    ctx = torch.cat([ctx_of(n) for n in names], dim=0)
    eps = eps_cond_fn(torch.cat([x] * len(names), dim=0), t, ctx)
    parts = dict(zip(names, eps.chunk(len(names), dim=0)))
    g, ge = guidance_scale, guidance_scale_edit

    if mode == "null+(for-null)":
        return parts["null"] + g * (parts["for"] - parts["null"])
    if mode == "null+(for-null)+(edit-null)":
        return (parts["null"] + g * (parts["for"] - parts["null"])
                + ge * (parts["edit"] - parts["null"]))
    if mode == "null+(edit-null)":
        return parts["null"] + g * (parts["edit"] - parts["null"])
    if mode == "(for-edit)":
        return g * (parts["for"] - parts["edit"])
    if mode == "(for-null)":
        return g * (parts["for"] - parts["null"])
    if mode == "(edit-null)":
        return g * (parts["edit"] - parts["null"])
    if mode == "edit-proj[for](edit)":
        return perpendicular_component(parts["edit"] - parts["null"],
                                       parts["for"] - parts["null"])
    if mode == "null+for+edit-proj[for](edit)":
        e_for = parts["for"] - parts["null"]
        e_edit = perpendicular_component(parts["edit"] - parts["null"], e_for)
        return parts["null"] + g * e_for + ge * e_edit
    raise AssertionError(mode)

"""Shared engine execution machinery (port of loco_edit_tpu/pipelines/common.py,
without the device mesh).

  - Overlapped artifact IO: disk artifacts (.npz direction caches, PNG
    strips) are written on one IO thread so they overlap device work; they
    are drained before any cache-existence check and before every public
    run_* method returns.
  - Memory-bound chunking: big frame batches are denoised in chunks of
    cfg.memory_bound frames (0 = one batch).
  - Phase timings: wall time per pipeline phase, each ended by a device
    synchronize.
  - Walk strips of every principal component concatenated into one frame
    batch, and split back.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from loco_edit_tpu_torch.utils.chunk import map_chunked


class EngineExec:
    """Mixin for edit pipelines: overlapped artifact IO and chunked batch
    execution. Expects `self.cfg` with an optional `memory_bound` field.
    State is created lazily so engines need no __init__ cooperation."""

    def _submit_io(self, fn, *args, **kw):
        if getattr(self, "_io_pool", None) is None:
            self._io_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="loco-io")
            self._io_pending = []
        self._io_pending.append(self._io_pool.submit(fn, *args, **kw))

    def flush_io(self):
        """Wait for every queued artifact write (re-raising any error)."""
        pending = getattr(self, "_io_pending", None)
        if not pending:
            return
        self._io_pending = []
        for f in pending:
            f.result()

    def run_batched(self, fn: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
        """Apply a batch-preserving fn over x's leading axis, in chunks of
        cfg.memory_bound (fn is called once per chunk)."""
        return map_chunked(fn, x, getattr(self.cfg, "memory_bound", 0))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _Phase:
    """Wall time of one pipeline phase, ended by a device synchronize so the
    device work is inside it; accumulates into timings[name]."""

    def __init__(self, timings: dict, name: str, device: torch.device):
        self.timings, self.name, self.device = timings, name, device

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[self.name] = (self.timings.get(self.name, 0.0)
                                   + time.perf_counter() - self.t0)


def concat_pc_strips(xt: torch.Tensor, vT: torch.Tensor, n_pc: int, *, scale: float,
                     edit_step: float, num_steps: int, vis_num: int):
    """Every principal component's x-space-guidance walk strip, and their
    concatenation into ONE frame batch (one chunked denoise of it replaces a
    batch per component). Returns (per_pc list, concatenation or None)."""
    from loco_edit_tpu_torch.editing import x_space_guidance_strip

    per_pc = [x_space_guidance_strip(xt, vT[pc], scale=scale, edit_step=edit_step,
                                     num_steps=num_steps, vis_num=vis_num)
              for pc in range(n_pc)]
    if not per_pc:
        return [], None
    return per_pc, torch.cat(per_pc, dim=0)


def split_pc_strips(per_pc, batch_out) -> dict[int, np.ndarray]:
    """Split a concatenated per-PC result batch back into {pc: frames}."""
    arr = _host(batch_out) if isinstance(batch_out, torch.Tensor) else np.asarray(batch_out)
    out, offset = {}, 0
    for pc, sp in enumerate(per_pc):
        out[pc] = arr[offset:offset + sp.shape[0]]
        offset += sp.shape[0]
    return out

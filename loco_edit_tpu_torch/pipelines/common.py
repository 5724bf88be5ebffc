"""Shared engine execution machinery (port of loco_edit_tpu/pipelines/common.py).

  - Overlapped artifact IO: disk artifacts (.npz direction caches, PNG
    strips) are written on one IO thread so they overlap device work; they
    are drained before any cache-existence check and before every public
    run_* method returns.
  - Memory-bound chunking: big frame batches are denoised in chunks of
    cfg.memory_bound frames (0 = one batch).
  - Phase timings: wall time per pipeline phase, each ended by a device
    synchronize; each phase is a program span (utils/logger.py), and every
    wait of the host for the card a `readback` span.
  - Walk strips of every principal component concatenated into one frame
    batch, and split back.
  - Mesh axes over torch.distributed ranks (core/mesh.py): --mesh_probe
    splits the subspace iteration's probes (editing/pullback.py),
    --mesh_data the walk-strip frames and the batch-edit samples. Every
    rank runs the same program; rank 0 writes the artifacts.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from loco_edit_tpu_torch.core.device import to_device
from loco_edit_tpu_torch.core.mesh import (DATA_AXIS, PROBE_AXIS, is_main_process,
                                           make_mesh, world_size)
from loco_edit_tpu_torch.core.rng import RowWindow
from loco_edit_tpu_torch.parallel.collectives import gather_cat
from loco_edit_tpu_torch.utils.chunk import map_chunked
from loco_edit_tpu_torch.utils.logger import Span, readback, resolve_device_times


class EngineExec:
    """Mixin for edit pipelines: overlapped artifact IO, mesh sharding
    (probe / data axes) and chunked batch execution. Expects `self.rng` and
    `self.cfg` with optional `memory_bound`, `mesh_probe` and `mesh_data`
    fields; every helper is a one-rank no-op when a field is absent or at most 1.
    State is created lazily so engines need no __init__ cooperation."""

    def _tensor(self, x) -> torch.Tensor:
        """x as a float32 tensor on the engine's device."""
        return to_device(x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32),
                         self.device)

    def _submit_io(self, fn, *args, **kw):
        if not is_main_process():
            return     # rank 0 writes the artifacts
        if getattr(self, "_io_pool", None) is None:
            self._io_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="loco-io")
            self._io_pending = []
        self._io_pending.append(self._io_pool.submit(fn, *args, **kw))

    def flush_io(self):
        """Wait for every queued artifact write (re-raising any error). With
        more than one rank, every rank waits until rank 0's writes are on
        disk, so that the ranks' cache-existence checks agree."""
        pending = getattr(self, "_io_pending", None)
        if pending:
            self._io_pending = []
            for f in pending:
                f.result()
        if world_size() > 1:
            import torch.distributed as dist

            dist.barrier()

    def _mesh(self, field: str, axis: str):
        n = getattr(self.cfg, field, 0)
        if n <= 1:
            return None
        meshes = self.__dict__.setdefault("_meshes", {})
        if field not in meshes:   # make_mesh raises unless n is the world size
            meshes[field] = make_mesh({axis: n})
        return meshes[field]

    def _probe_sharding(self):
        """The probe-axis mesh when cfg.mesh_probe > 1 (solo AND fused
        extraction split their probes over it), else None."""
        return self._mesh("mesh_probe", PROBE_AXIS)

    def _data_sharding(self):
        """The data-axis mesh when cfg.mesh_data > 1 (the walk-strip /
        batch-edit axis), else None."""
        return self._mesh("mesh_data", DATA_AXIS)

    def _split_over_data(self, fn, x: torch.Tensor, mesh) -> torch.Tensor:
        """fn over x's leading axis padded to the mesh and split into equal
        shares, one a rank, the results all-gathered (the same on every
        rank) and the padding dropped. While fn runs, self.rng is a
        core/rng.py::RowWindow over this rank's rows, so its draws are the
        whole padded batch's rows and the result equals the unsharded run of
        the padded batch."""
        b = x.shape[0]
        pad = (-b) % mesh.size
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        per = x.shape[0] // mesh.size
        lo = mesh.coordinate(DATA_AXIS) * per
        rng = self.rng
        self.rng = RowWindow(rng, lo, per, x.shape[0])
        try:
            out = fn(x[lo:lo + per])
        finally:
            self.rng = rng
        out = gather_cat(out, 0, mesh.group(DATA_AXIS))
        return out[:b] if pad else out

    def run_batched(self, fn: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
        """Apply a batch-preserving fn over x's leading axis: split over the
        data mesh when cfg.mesh_data > 1, else in chunks of cfg.memory_bound
        (fn is called once per chunk)."""
        mesh = self._data_sharding()
        if mesh is not None:
            return self._split_over_data(fn, x, mesh)
        return map_chunked(fn, x, getattr(self.cfg, "memory_bound", 0))

    def shard_samples(self, fn: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor) -> torch.Tensor:
        """--mesh_data for a batch-edit sample axis: fn(x) split over the
        data mesh (padded to it), or fn(x) in one call without one."""
        mesh = self._data_sharding()
        return fn(x) if mesh is None else self._split_over_data(fn, x, mesh)


def _host(t: torch.Tensor) -> np.ndarray:
    """t on the host: the one way the engines read a tensor back."""
    with readback():
        return t.detach().cpu().numpy()


class _Phase(Span):
    """Wall time of one pipeline phase, ended by a device synchronize so the
    device work is inside it; accumulates into timings[name]. A span of
    its own name; the synchronize is a readback, after which the phase's
    sweeps get their device times."""

    def __init__(self, timings: dict, name: str, device: torch.device):
        super().__init__(name)
        self.timings, self.dev = timings, device

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            with readback():
                torch.cuda.synchronize(self.dev)
            resolve_device_times()
        super().__exit__(*exc)
        self.timings[self.name] = self.timings.get(self.name, 0.0) + self.seconds


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

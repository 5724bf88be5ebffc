"""Device-mesh topology over torch.distributed (port of
loco_edit_tpu/core/mesh.py).

The JAX package builds a `jax.sharding.Mesh` over the devices of one program
and lets XLA insert the collectives. Here every rank is a process: the mesh
is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of the process
group, its axes are process groups, and the port's parallel modules call the
collectives themselves (parallel/collectives.py).

Axis conventions used throughout:
  - DATA_AXIS  ("data"):  batch / walk-strip / microbatch axis (DP).
  - PROBE_AXIS ("probe"): probe-vector axis of the Jacobian subspace
    iteration, the embarrassingly-parallel dimension of the workload.

With one process there is no process group: a mesh of size 1 is the
identity and every collective on it is a no-op.

The backend rule (`choose_backend`): `nccl` when every rank of a host has a
card of its own; `gloo` on the CPU, and for more ranks than cards on a host
(NCCL refuses two ranks on one GPU). Gloo moves CUDA tensors through host
memory; that is transport, and no op of the model runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
PROBE_AXIS = "probe"


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on rank 0, and when no process group is running."""
    return rank() == 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over every rank (row-major). `device_mesh` is the
    DeviceMesh when the mesh spans more than one rank, else None."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device_mesh: object | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def group(self, axis: str):
        """The process group of `axis` this rank belongs to; None when the
        axis has one rank."""
        if self.device_mesh is None or self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis`."""
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))


def make_mesh(axis_sizes: dict[str, int] | None = None) -> Mesh:
    """A Mesh over every rank of the process group (one rank without one)
    with the given axis sizes.

    `axis_sizes` maps axis name -> size; one axis may be -1 to absorb the
    remaining ranks. Default: all ranks on DATA_AXIS. Raises ValueError when
    the sizes do not multiply to the world size, as the JAX package does
    with too few devices. (JAX can also take the first n of more devices;
    here every rank runs the program, so a mesh spans them all.)"""
    names = [DATA_AXIS] if axis_sizes is None else list(axis_sizes.keys())
    sizes = resolve_axis_sizes(axis_sizes, world_size())
    device_mesh = None
    if world_size() > 1:
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(_mesh_device_type(), tuple(sizes),
                                       mesh_dim_names=tuple(names))
    return Mesh(tuple(names), tuple(sizes), device_mesh)


def resolve_axis_sizes(axis_sizes: dict[str, int] | None, n: int) -> list[int]:
    """The axis sizes of a mesh over n ranks, the one -1 axis filled in;
    ValueError when they do not multiply to n."""
    if axis_sizes is None:
        return [n]
    names, sizes = list(axis_sizes.keys()), list(axis_sizes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    total = math.prod(sizes)
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} ranks, have {n}")
    return sizes


def local_mesh(probe: int | None = None) -> Mesh:
    """("data", "probe") over every rank, probe innermost."""
    n = world_size()
    if probe is None:
        probe = n
    return make_mesh({DATA_AXIS: n // probe, PROBE_AXIS: probe})


def shard_leading(mesh: Mesh, axis: str) -> tuple[Mesh, list]:
    """Placements that split a tensor's leading dim over `axis` and
    replicate it over the other axes (a DTensor layout)."""
    return mesh, [Shard(0) if a == axis else Replicate() for a in mesh.axis_names]


def replicated(mesh: Mesh) -> tuple[Mesh, list]:
    return mesh, [Replicate() for _ in mesh.axis_names]


def _mesh_device_type() -> str:
    return "cuda" if _BACKEND.get("device") == "cuda" else "cpu"


_BACKEND: dict[str, str] = {}


def choose_backend(device_type: str, local_world: int,
                   cards: int | None = None) -> str:
    """nccl when every one of `local_world` ranks on a host has a card of
    its own, else gloo (the CPU; more ranks than cards)."""
    if device_type != "cuda":
        return "gloo"
    cards = torch.cuda.device_count() if cards is None else cards
    return "nccl" if cards >= local_world else "gloo"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device: str | torch.device = "cuda") -> str | None:
    """Start the process group (the JAX package's multi-host rendezvous).

    With no arguments it reads torchrun's environment (WORLD_SIZE, RANK,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT). A no-op for one
    process, or when a group is already running. On the card a rank uses
    cuda:LOCAL_RANK (modulo the cards present) and makes it current. The
    backend follows `choose_backend` and is printed. Returns the backend,
    or None when nothing was started."""
    if dist.is_initialized():
        return dist.get_backend()
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return None
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dev = torch.device(device)
    backend = choose_backend(dev.type, local_world)
    if dev.type == "cuda":
        index = local_rank % max(torch.cuda.device_count(), 1)
        torch.cuda.set_device(index)
        where = f"cuda:{index}"
    else:
        where = "cpu"
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   and "://" not in coordinator_address else coordinator_address)
    if init_method is None and "MASTER_ADDR" not in os.environ:
        raise ValueError("initialize_distributed: give coordinator_address "
                         "(host:port) or set MASTER_ADDR and MASTER_PORT")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=num_processes, rank=process_id)
    _BACKEND.update(backend=backend, device=dev.type)
    print(f"[rank {process_id}/{num_processes}] backend {backend}, device {where}",
          flush=True)
    return backend

"""Run a function in N processes joined by torch.distributed (gloo on the
CPU), for the tests of the port's mesh and parallel modules.

`run_ranks(fn, payload, world)` spawns `world` processes (`Ranks` starts
them and `join` waits, so that the parent can work meanwhile); each starts the
process group through loco_edit_tpu_torch.core.mesh.initialize_distributed,
runs fn(payload) with one thread, and sends back what fn returns (numpy
arrays and plain values). Every join has a timeout: a rank that fails or
hangs kills the group and fails the test. fn must be importable by the
children (a module-level function of a module without JAX, so that the
ranks start fast)."""

import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import socket
import tempfile
import time
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, payload_path, queue):
    try:
        import torch

        torch.set_num_threads(1)
        from loco_edit_tpu_torch.core.mesh import initialize_distributed

        initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        out = fn(payload)
        queue.put((rank, "ok", out))
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    except BaseException:   # noqa: BLE001: reported to the parent, which fails
        queue.put((rank, "error", traceback.format_exc()))


class Ranks:
    """`world` spawned gloo ranks running fn(payload); join() waits for
    their results (rank order), raising on a rank's error or after
    `timeout` seconds from the start, and always kills what is left."""

    def __init__(self, fn, payload, world: int = 4, timeout: float = 120.0):
        ctx = mp.get_context("spawn")
        self.world, self.queue = world, ctx.Queue()
        with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as f:
            pickle.dump(payload, f)
            self.path = f.name
        port = _free_port()
        self.procs = [ctx.Process(target=_entry, args=(r, world, port, fn, self.path,
                                                       self.queue), daemon=True)
                      for r in range(world)]
        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            for p in self.procs:
                p.start()
        finally:
            if saved is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        self.deadline = time.monotonic() + timeout

    def join(self) -> list:
        results = {}
        try:
            while len(results) < self.world:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(self.world)) - set(results))
                    raise TimeoutError(f"ranks {missing} did not finish in time")
                try:
                    rank, status, out = self.queue.get(timeout=min(left, 5.0))
                except queue_mod.Empty:   # check the processes are alive
                    dead = [r for r, p in enumerate(self.procs)
                            if p.exitcode not in (None, 0) and r not in results]
                    if dead:
                        raise RuntimeError(f"ranks {dead} died without a result")
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                results[rank] = out
            for p in self.procs:
                p.join(timeout=max(1.0, self.deadline - time.monotonic()))
            return [results[r] for r in range(self.world)]
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
            if os.path.exists(self.path):
                os.remove(self.path)


def run_ranks(fn, payload, world: int = 4, timeout: float = 120.0) -> list:
    """fn(payload) on each of `world` gloo ranks; returns the ranks' results
    in rank order. Raises on a rank's error or after `timeout` seconds."""
    return Ranks(fn, payload, world, timeout).join()

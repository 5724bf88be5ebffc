"""RNG discipline (port of loco_edit_tpu/core/rng.py).

One root seed per run; named, independent child streams are derived by
hashing (the counterpart of `jax.random.fold_in`), so every consumer (probe
init, eta-noise per sampling step) is reproducible and order-independent.
A stream draws through a `torch.Generator` seeded from its derived seed.

Consumers take a stream, not a generator: anything with `fork`, `at_step`
and `normal` can stand in for one, which is how tests feed the JAX package's
`fold_in` draws through the port.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import random

import numpy as np
import torch


def _stable_hash(name: str) -> int:
    """Deterministic 32-bit hash of a stream name (the JAX package's)."""
    return int.from_bytes(hashlib.blake2b(name.encode(), digest_size=4).digest(), "big")


def _mix(seed: int, data: int) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(seed.to_bytes(8, "little") + int(data).to_bytes(8, "little"))
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


@dataclasses.dataclass(frozen=True)
class RngStream:
    """A named, forkable source of torch random draws rooted at one seed."""

    seed: int

    @classmethod
    def from_seed(cls, seed: int) -> "RngStream":
        return cls(seed=_mix(0, seed))

    def fork(self, name: str) -> "RngStream":
        """Derive an independent child stream identified by `name`."""
        return RngStream(seed=_mix(self.seed, _stable_hash(name)))

    def at_step(self, step: int) -> "RngStream":
        """Child stream for an integer step (a sampling step, a call count)."""
        return RngStream(seed=_mix(self.seed, step))

    def generator(self, device="cpu") -> torch.Generator:
        """A torch.Generator on `device` seeded from this stream."""
        return torch.Generator(device=device).manual_seed(self.seed)

    def normal(self, shape, *, device, dtype=torch.float32) -> torch.Tensor:
        """Standard normal draw of `shape` from this stream's generator."""
        return torch.randn(tuple(shape), generator=self.generator(device),
                           device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class RowWindow:
    """A stream seen by the rank that runs rows [lo, lo + n) of a `total`-row
    batch: every draw is made for the whole batch from the wrapped stream and
    this rank's rows are returned, so a data-sharded run draws what the
    unsharded run draws for those rows (the JAX package's draws of a sharded
    program). A draw must have n rows; any other draw raises."""

    stream: object
    lo: int
    n: int
    total: int

    def fork(self, name: str) -> "RowWindow":
        return dataclasses.replace(self, stream=self.stream.fork(name))

    def at_step(self, step: int) -> "RowWindow":
        return dataclasses.replace(self, stream=self.stream.at_step(step))

    def normal(self, shape, *, device, dtype=torch.float32) -> torch.Tensor:
        shape = tuple(shape)
        if not shape or shape[0] != self.n:
            raise ValueError(f"a draw of shape {shape} inside a share of {self.n} "
                             f"rows of {self.total}: only draws of the share's "
                             "rows can be drawn for the whole batch")
        full = self.stream.normal((self.total,) + shape[1:], device=device, dtype=dtype)
        return full[self.lo:self.lo + self.n]


def seed_everything(seed: int) -> RngStream:
    """Seed host-side RNGs (numpy / python / PYTHONHASHSEED / torch's global
    generator) and return the root stream."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed % (2**32))
    random.seed(seed)
    torch.manual_seed(seed)
    return RngStream.from_seed(seed)

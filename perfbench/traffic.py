"""The one traffic generator: turns a mix's parameters and --seed into the
run's requests, the same requests for the same seed.

A mix (perfbench/traffic/<name>.json) sets:

- "warmup": how many requests set-up sends before the window;
- "mask_cover": [lo, hi], the share of the image a request's box mask
  covers, drawn uniformly, with an aspect ratio between 1:2 and 2:1;
- "prompts": T2I prompts, one drawn a request (none: an unconditional
  engine).

Every request is a fresh edit: it names a new sample by a seed (x_T or
z_T) and a sample_name that keys the server's basis cache, so no request
finds its basis cached. Every request asks for uint8 pixels ("pixel":
true), and a T2I request for the unsupervised direction ("semantic":
false), which is what the engines and the reference implement.
"""

from __future__ import annotations

import numpy as np


def _box(rng: np.random.Generator, hw, cover) -> list[int]:
    h, w = hw
    area = rng.uniform(*cover) * h * w
    aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0)))
    bh = int(np.clip(round(np.sqrt(area * aspect)), 1, h))
    bw = int(np.clip(round(area / bh), 1, w))
    y0 = int(rng.integers(0, h - bh + 1))
    x0 = int(rng.integers(0, w - bw + 1))
    return [y0, y0 + bh, x0, x0 + bw]


def _sample(rng: np.random.Generator, i: int, traffic: dict, mask_hw) -> dict:
    req = {"seed": int(rng.integers(1, 2**62)), "sample_name": f"sample{i:05d}",
           "mask_bbox": _box(rng, mask_hw, traffic["mask_cover"]), "pixel": True}
    prompts = traffic.get("prompts") or []
    if prompts:
        req["for_prompt"] = prompts[int(rng.integers(len(prompts)))]
        req["semantic"] = False
    return req


def requests(traffic: dict, seed: int, mask_hw):
    """(warm-up requests, an endless iterator of window requests)."""
    rng = np.random.default_rng(seed)
    n_warm = int(traffic["warmup"])
    warm = [_sample(rng, i, traffic, mask_hw) for i in range(n_warm)]

    def window():
        i = n_warm
        while True:
            yield _sample(rng, i, traffic, mask_hw)
            i += 1

    return warm, window()

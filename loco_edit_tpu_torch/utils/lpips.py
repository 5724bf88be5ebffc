"""LPIPS (Learned Perceptual Image Patch Similarity) in PyTorch (port of
loco_edit_tpu/utils/lpips_flax.py).

AlexNet / VGG16 feature taps, per-tap channel unit-normalization, squared
difference, learned 1x1 "lin" heads, spatial average, sum over taps (Zhang
et al. 2018, the computation torchmetrics vendors from the `lpips`
package). Its convolutions are cuDNN's: LPIPS reaches no hand-written
kernel.

Weights come from a LOCAL torch checkpoint (no hub egress):
  - a full `lpips.LPIPS(net=...)`/torchmetrics state_dict
    (`net.sliceK.I.weight` backbone + `linK.model.1.weight` heads), or
  - a torchvision backbone state_dict (`features.I.weight`) paired with the
    lpips package's head-only checkpoint (`linK.model.1.weight`).

`convert_lpips_state_dict` normalizes all of these into the state_dict of
`LPIPS`, with strict key coverage.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from loco_edit_tpu_torch.core.device import resolve_device

# lpips ScalingLayer constants (shift/scale buffers in the reference ckpt)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision `features` indices of the conv layers feeding each LPIPS tap
_ALEX_CONVS = (0, 3, 6, 8, 10)          # taps after relu1..relu5
_ALEX_CH = (64, 192, 384, 256, 256)
# VGG16: taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_VGG_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_CH = (64, 128, 256, 512, 512)
# the lpips package's slice of each of those convs (its net.sliceK.I naming)
_ALEX_SLICES = (1, 2, 3, 4, 5)
_VGG_SLICES = (1, 1, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5)
# AlexNet: (out_ch, kernel, stride, pad, pool_before) per conv
_ALEX_SPEC = ((64, 11, 4, 2, False), (192, 5, 1, 2, True), (384, 3, 1, 1, True),
              (256, 3, 1, 1, False), (256, 3, 1, 1, False))
_VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class AlexFeatures(nn.Module):
    """torchvision AlexNet `features` trunk, NCHW, ReLU taps."""

    def __init__(self):
        super().__init__()
        ins = (3,) + tuple(s[0] for s in _ALEX_SPEC[:-1])
        self.convs = nn.ModuleList(
            nn.Conv2d(ci, co, k, stride=s, padding=p)
            for ci, (co, k, s, p, _) in zip(ins, _ALEX_SPEC))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for conv, (*_, pool) in zip(self.convs, _ALEX_SPEC):
            if pool:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(conv(x))
            taps.append(x)
        return taps


class VGG16Features(nn.Module):
    """torchvision VGG16 `features` trunk, NCHW, LPIPS tap points."""

    def __init__(self):
        super().__init__()
        chans = [co for co, n in _VGG_PLAN for _ in range(n)]
        self.convs = nn.ModuleList(nn.Conv2d(ci, co, 3, padding=1)
                                   for ci, co in zip([3] + chans[:-1], chans))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps, ci = [], 0
        for bi, (_, n) in enumerate(_VGG_PLAN):
            if bi > 0:
                x = F.max_pool2d(x, 2, 2)
            for _ in range(n):
                x = F.relu(self.convs[ci](x))
                ci += 1
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    """LPIPS distance; inputs NHWC in [-1, 1]. Returns (B,) distances."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        if net not in ("alex", "vgg"):
            raise ValueError(f"LPIPS net must be 'alex' or 'vgg', got {net!r}")
        self.net = net
        self.trunk = AlexFeatures() if net == "alex" else VGG16Features()
        chans = _ALEX_CH if net == "alex" else _VGG_CH
        for k, c in enumerate(chans):
            self.register_parameter(f"lin{k}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        def prep(x):
            return (x.float().permute(0, 3, 1, 2) - self.shift) / self.scale

        fa, fb = self.trunk(prep(a)), self.trunk(prep(b))
        total = 0.0
        for k, (xa, xb) in enumerate(zip(fa, fb)):
            # lpips normalize_tensor: x / (||x||_ch + 1e-10)
            na = xa / (xa.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            nb = xb / (xb.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            d = (na - nb).pow(2)
            w = getattr(self, f"lin{k}")
            total = total + torch.einsum("bchw,c->bhw", d, w).mean(dim=(1, 2))
        return total


def _normalize_keys(sd: Mapping) -> dict[str, np.ndarray]:
    """Strip wrapper prefixes and make values numpy (accepts tensors).

    torchmetrics prefixes everything with one extra `net.` (`net.lin0...`,
    `net.net.slice1...`); the lpips package registers the heads twice
    (attributes `lin0..lin4` AND the ModuleList `lins.0..lins.4` hold the
    same modules), so `lins.K.*` aliases are renamed to `linK.*` and
    deduped."""
    out = {}
    for k, v in sd.items():
        arr = v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v)
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith(("net.lin", "net.scaling_layer", "net.net.")):
            k = k[len("net."):]  # torchmetrics NoTrainLpips wrapper prefix
        if k.startswith("lins."):
            idx, _, tail = k[len("lins."):].partition(".")
            k = f"lin{idx}.{tail}"
        out[k] = arr
    return out


def convert_lpips_state_dict(state_dict: Mapping, lin_state_dict: Mapping | None = None,
                             net: str | None = None) -> tuple[dict, str]:
    """Torch LPIPS weights -> the state_dict of `LPIPS(net)`.

    state_dict: a full lpips/torchmetrics LPIPS state_dict, OR a torchvision
    backbone state_dict (`features.I.*`, or a bare `features` dump with keys
    like "0.weight"). lin_state_dict: head-only dict (`linK.model.1.weight`
    / `linK.weight`) when the backbone dict has no heads. Returns
    (state_dict, net_name). Strict: unknown keys raise."""
    sd = _normalize_keys(state_dict)
    if lin_state_dict is not None:
        sd.update(_normalize_keys(lin_state_dict))

    convs: dict[int, dict[str, np.ndarray]] = {}
    lins: dict[int, np.ndarray] = {}
    consumed = set()
    for k, v in sd.items():
        parts = k.split(".")
        if "slice" in k:  # net.sliceK.I.{weight,bias} (lpips/torchmetrics)
            convs.setdefault(int(parts[-2]), {})[parts[-1]] = v
            consumed.add(k)
        elif parts[0] == "features":  # torchvision backbone
            convs.setdefault(int(parts[1]), {})[parts[-1]] = v
            consumed.add(k)
        elif parts[0].isdigit() and parts[-1] in ("weight", "bias"):
            convs.setdefault(int(parts[0]), {})[parts[-1]] = v
            consumed.add(k)
        elif parts[0] in ("classifier", "avgpool"):
            consumed.add(k)  # torchvision heads: never part of LPIPS
        elif parts[0].startswith("lin") and parts[0][3:].isdigit():
            # linK.model.1.weight (lpips) / linK.weight (flat)
            if parts[-1] == "weight":
                lins[int(parts[0][3:])] = v.reshape(-1)
                consumed.add(k)
        elif parts[-1] in ("shift", "scale") or "scaling_layer" in k:
            consumed.add(k)  # constants, built in
    unknown = sorted(set(sd) - consumed)
    if unknown:
        raise ValueError(f"unconverted LPIPS keys: {unknown[:8]}")

    first = convs[min(convs)]["weight"]
    if net is None:
        net = "alex" if first.shape[-1] == 11 else "vgg"
    conv_idx = _ALEX_CONVS if net == "alex" else _VGG_CONVS
    chans = _ALEX_CH if net == "alex" else _VGG_CH
    if sorted(convs) != sorted(conv_idx):
        raise ValueError(f"backbone layer indices {sorted(convs)} do not match "
                         f"{net} expectation {sorted(conv_idx)}")
    if sorted(lins) != [0, 1, 2, 3, 4]:
        raise ValueError(f"expected lin heads 0..4, got {sorted(lins)}; pass "
                         "lin_state_dict with the lpips head checkpoint")
    out = {}
    for j, fi in enumerate(conv_idx):
        out[f"trunk.convs.{j}.weight"] = torch.from_numpy(
            np.asarray(convs[fi]["weight"], np.float32))
        out[f"trunk.convs.{j}.bias"] = torch.from_numpy(
            np.asarray(convs[fi]["bias"], np.float32))
    for k in range(5):
        w = np.asarray(lins[k], np.float32)
        if w.size != chans[k]:
            raise ValueError(f"lin{k} has {w.size} weights, expected {chans[k]}")
        out[f"lin{k}"] = torch.from_numpy(w.copy())
    return out, net


def lpips_package_state_dict(state_dict: Mapping, net: str) -> dict[str, torch.Tensor]:
    """An `LPIPS(net)` state_dict in the lpips package's naming
    (net.sliceK.I.{weight,bias} + linK.model.1.weight): the inverse of
    convert_lpips_state_dict, for writing checkpoints its loaders read."""
    convs = _ALEX_CONVS if net == "alex" else _VGG_CONVS
    slices = _ALEX_SLICES if net == "alex" else _VGG_SLICES
    out = {}
    for j, (fi, sl) in enumerate(zip(convs, slices)):
        for leaf in ("weight", "bias"):
            out[f"net.slice{sl}.{fi}.{leaf}"] = state_dict[f"trunk.convs.{j}.{leaf}"]
    for k in range(5):
        out[f"lin{k}.model.1.weight"] = state_dict[f"lin{k}"].reshape(1, -1, 1, 1)
    return out


def lpips_params_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's LPIPSFlax variables ({"params": {"trunk": {"convJ":
    {"kernel" HWIO, "bias"}}, "linK": (C,)}}) as an LPIPS state_dict."""
    p = variables["params"]
    out = {}
    for j in range(len(p["trunk"])):
        conv = p["trunk"][f"conv{j}"]
        out[f"trunk.convs.{j}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(conv["kernel"], np.float32),
                                              (3, 2, 0, 1))))
        out[f"trunk.convs.{j}.bias"] = torch.from_numpy(np.asarray(conv["bias"], np.float32))
    for k in range(5):
        out[f"lin{k}"] = torch.from_numpy(np.asarray(p[f"lin{k}"], np.float32))
    return out


class LPIPSMetric:
    """Bound LPIPS metric: load once, call many times."""

    def __init__(self, model: LPIPS):
        self.model = model.requires_grad_(False).eval()
        self.net = model.net
        self.device = next(model.parameters()).device

    @classmethod
    def from_state_dict(cls, state_dict: Mapping, lin_state_dict: Mapping | None = None,
                        net: str | None = None,
                        device: str | torch.device = "cuda") -> "LPIPSMetric":
        sd, net = convert_lpips_state_dict(state_dict, lin_state_dict, net)
        with torch.device(resolve_device(device)):
            model = LPIPS(net)
        model.load_state_dict(sd)
        return cls(model)

    @classmethod
    def from_torch_file(cls, path: str, lin_path: str | None = None,
                        net: str | None = None,
                        device: str | torch.device = "cuda") -> "LPIPSMetric":
        """From a local checkpoint (and the lpips heads' file), on `device`:
        the card unless the caller asks for the CPU."""
        from loco_edit_tpu_torch.models.adm.convert import load_torch_checkpoint

        lin = load_torch_checkpoint(lin_path) if lin_path else None
        return cls.from_state_dict(load_torch_checkpoint(path), lin, net, device)

    @torch.no_grad()
    def __call__(self, a, b, normalize: bool = False) -> torch.Tensor:
        """a, b: NHWC (numpy or tensors). normalize=True maps [0,1] ->
        [-1,1] (the torchmetrics convention). Returns (B,) on self.device."""
        a, b = (torch.as_tensor(np.asarray(t, np.float32)) if not isinstance(t, torch.Tensor)
                else t for t in (a, b))
        a, b = a.to(self.device, torch.float32), b.to(self.device, torch.float32)
        if normalize:
            a, b = a * 2.0 - 1.0, b * 2.0 - 1.0
        return self.model(a, b)

"""Evaluation metrics: SSIM, masked MSE, (gated) LPIPS (port of
loco_edit_tpu/utils/metrics.py).

SSIM follows the standard Wang et al. formulation (gaussian window 11,
sigma 1.5, k1/k2 = 0.01/0.03, valid padding) that torchmetrics implements.
Inputs are NHWC in [0, data_range] (numpy arrays or tensors); every metric
returns one f32 value per batch element, as a tensor on the device it ran
on: a tensor's own device, or `device` for numpy inputs (the card unless
the caller asks for the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from loco_edit_tpu_torch.core.device import resolve_device


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    r = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(r ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D convolution, valid padding; x NHWC."""
    c = x.shape[-1]
    w = kernel[None, None].expand(c, 1, *kernel.shape)
    return F.conv2d(x.permute(0, 3, 1, 2), w, groups=c).permute(0, 2, 3, 1)


def ssim(a, b, data_range: float = 1.0, k1: float = 0.01, k2: float = 0.03,
         device=None) -> torch.Tensor:
    """Mean SSIM per batch element; a, b: (B, H, W, C) in [0, data_range]."""
    a = _as_tensor(a, device)
    b = _as_tensor(b, a.device)
    kern = _gaussian_kernel(device=a.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a = _filter2d(a, kern)
    mu_b = _filter2d(b, kern)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2d(a * a, kern) - mu_aa
    s_bb = _filter2d(b * b, kern) - mu_bb
    s_ab = _filter2d(a * b, kern) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return (num / den).mean(dim=(1, 2, 3))


def masked_mse(a, b, mask=None, device=None) -> torch.Tensor:
    """Mean squared error per batch element, optionally restricted to mask
    (the reference's edit-locality metric: MSE outside the edit region)."""
    a = _as_tensor(a, device)
    b = _as_tensor(b, a.device)
    sq = (a - b) ** 2
    axes = tuple(range(1, sq.ndim))
    if mask is None:
        return sq.mean(dim=axes)
    m = _as_tensor(mask, a.device).broadcast_to(sq.shape)
    return (sq * m).sum(dim=axes) / m.sum(dim=axes).clamp(min=1.0)


_lpips_cache: dict = {}

# the torchvision checkpoints torchmetrics' LPIPS backbones load
_TORCHVISION_BACKBONES = {
    "alex": "alexnet-owt-7be5be79.pth",
    "vgg": "vgg16-397923af.pth",
    "squeeze": "squeezenet1_1-b8a52dc0.pth",
}


def _torchvision_backbone_file(net: str) -> str:
    """Where torch hub keeps the torchvision backbone of `net` locally."""
    return os.path.join(torch.hub.get_dir(), "checkpoints",
                        _TORCHVISION_BACKBONES.get(net, f"{net}.pth"))


def lpips(a, b, net: str | None = None, weights_path: str | None = None,
          device=None) -> torch.Tensor:
    """LPIPS; a, b: NHWC in [0, 1].

    net: backbone ("alex"/"vgg"). None (default) follows the checkpoint's
    backbone on the weights path (alex on the torchmetrics fallback); an
    explicit value is checked against the checkpoint, and a mismatch raises
    rather than scoring with the wrong network.

    Weights: the port's LPIPS (utils/lpips.py) from a LOCAL torch
    checkpoint: pass `weights_path` or set LOCO_LPIPS_WEIGHTS to a full
    lpips/torchmetrics state_dict (or "backbone.pth:lins.pth" for the
    torchvision-features + lpips-heads pair). Falls back to torchmetrics
    only when its backbone's torchvision weights are already in the local
    torch hub cache (torchmetrics would download them otherwise); raises
    with guidance when neither is there. Nothing here reaches the network."""
    weights_path = weights_path or os.environ.get("LOCO_LPIPS_WEIGHTS")
    ta = _as_tensor(a, device)
    tb = _as_tensor(b, ta.device)
    if weights_path:
        from loco_edit_tpu_torch.utils.lpips import LPIPSMetric

        # keyed by (path, mtime): replacing the checkpoint file on disk
        # within a process must not keep serving the stale converted metric
        main, _, lin = weights_path.partition(":")
        try:
            mtime = os.path.getmtime(main)
        except OSError:
            mtime = 0.0
        cache_key = (weights_path, mtime, str(ta.device))
        metric = _lpips_cache.get(cache_key)
        if metric is None:
            while len(_lpips_cache) >= 4:   # bound growth across paths/mtimes
                _lpips_cache.pop(next(iter(_lpips_cache)))
            metric = LPIPSMetric.from_torch_file(main, lin or None, device=ta.device)
            _lpips_cache[cache_key] = metric
        if net is not None and metric.net != net:
            raise ValueError(
                f"LPIPS weights at {weights_path!r} are a {metric.net!r} "
                f"backbone but net={net!r} was requested; pass "
                f"net={metric.net!r} or point at a {net} checkpoint")
        return metric(ta, tb, normalize=True)
    try:
        from torchmetrics.image.lpip import LearnedPerceptualImagePatchSimilarity
    except ImportError as e:
        raise ImportError(
            "LPIPS needs either a local weights file (set LOCO_LPIPS_WEIGHTS "
            "or pass weights_path; see utils/lpips.py) or torchmetrics "
            "with pretrained weights; or use ssim/masked_mse") from e
    cached = _torchvision_backbone_file(net or "alex")
    if not os.path.exists(cached):
        raise FileNotFoundError(
            f"LPIPS: no local weights. torchmetrics' {net or 'alex'} LPIPS needs "
            f"its torchvision backbone at {cached} (the torch hub cache), and "
            "this package never downloads it: copy the file there, or set "
            "LOCO_LPIPS_WEIGHTS / pass weights_path (see utils/lpips.py); or "
            "use ssim/masked_mse")
    metric = LearnedPerceptualImagePatchSimilarity(
        net_type=net or "alex", normalize=True).to(ta.device)
    ta, tb = ta.permute(0, 3, 1, 2), tb.permute(0, 3, 1, 2)
    with torch.no_grad():
        vals = [float(metric(ta[i:i + 1], tb[i:i + 1])) for i in range(ta.shape[0])]
    return torch.tensor(vals, device=ta.device)

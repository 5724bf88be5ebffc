"""Spectral utilities: radially-averaged power spectral density and Fourier
regularization (a numpy copy of loco_edit_tpu/utils/spectrum.py).

Parity surface for the reference's PSD observability (vis_psd plots of the
x_t / epsilon trajectories, src/modules/edit.py:2601-2609) and the
PullBackDDPM fourier_regularization / FFT helpers
(src/models/ddpm/diffusion.py:713-781). matplotlib is not in this image, so
plots are rendered as simple PNG line charts via PIL; raw curves are also
saved as .npz for downstream tooling."""

from __future__ import annotations

import os

import numpy as np


def power_spectral_density(x: np.ndarray) -> np.ndarray:
    """Radially-averaged PSD of an NHWC image batch, averaged over batch and
    channels. Returns (n_bins,) with n_bins = min(H, W) // 2."""
    x = np.asarray(x, np.float32)
    b, h, w, c = x.shape
    f = np.fft.fftshift(np.fft.fft2(x, axes=(1, 2)), axes=(1, 2))
    p = (np.abs(f) ** 2).mean(axis=(0, 3))
    cy, cx = h // 2, w // 2
    yy, xx = np.mgrid[:h, :w]
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2).astype(np.int64)
    nbins = min(h, w) // 2
    out = np.zeros((nbins,), np.float64)
    for i in range(nbins):
        m = r == i
        out[i] = p[m].mean() if m.any() else 0.0
    return out


def low_pass_filter(x: np.ndarray, cutoff_frac: float = 0.25) -> np.ndarray:
    """Ideal low-pass in the 2D Fourier domain (the fourier_regularization
    building block, ddpm/diffusion.py:752-781)."""
    x = np.asarray(x, np.float32)
    b, h, w, c = x.shape
    f = np.fft.fftshift(np.fft.fft2(x, axes=(1, 2)), axes=(1, 2))
    cy, cx = h // 2, w // 2
    yy, xx = np.mgrid[:h, :w]
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    mask = (r <= cutoff_frac * min(h, w))[None, :, :, None]
    return np.real(np.fft.ifft2(np.fft.ifftshift(f * mask, axes=(1, 2)),
                                axes=(1, 2))).astype(np.float32)


def fourier_regularize(v: np.ndarray, shape: tuple[int, int, int],
                       cutoff_frac: float = 0.25) -> np.ndarray:
    """Project flat direction rows onto low spatial frequencies and
    renormalize (the reference uses this to smooth edit directions)."""
    rows = np.asarray(v, np.float32).reshape(-1, *shape)
    filtered = low_pass_filter(rows, cutoff_frac)
    flat = filtered.reshape(rows.shape[0], -1)
    return flat / np.linalg.norm(flat, axis=1, keepdims=True)


def save_psd_plot(trajectories: list[np.ndarray], path: str,
                  size: tuple[int, int] = (640, 360)) -> None:
    """Save PSD curves (one per trajectory snapshot) as a log-log PNG line
    chart (PIL-rendered; no matplotlib in this environment) + a .npz of the
    raw curves."""
    from PIL import Image, ImageDraw

    curves = [power_spectral_density(t) for t in trajectories]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **{f"psd_{i}": c for i, c in enumerate(curves)})

    wpx, hpx = size
    img = Image.new("RGB", size, (255, 255, 255))
    draw = ImageDraw.Draw(img)
    eps = 1e-12
    logs = [np.log10(np.maximum(c, eps)) for c in curves]
    lo = min(l.min() for l in logs)
    hi = max(l.max() for l in logs)
    span = max(hi - lo, 1e-6)
    n = max(len(c) for c in curves)
    for i, l in enumerate(logs):
        shade = int(200 * i / max(len(logs) - 1, 1))
        color = (30 + shade, 60, 230 - shade)
        pts = [
            (int(j / max(n - 1, 1) * (wpx - 20)) + 10,
             hpx - 10 - int((v - lo) / span * (hpx - 20)))
            for j, v in enumerate(l)
        ]
        draw.line(pts, fill=color, width=2)
    img.save(path)

"""Gaussian pre-smoothing and Sobel gradients (port of
`gseg_tpu.ops.filters`).

Separable convolution as a sum of shifted, scaled planes with replicate
("edge") padding, taps applied in the reference's order so that the float32
result is bit-equal to it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps with radius ceil(4*sigma), float32."""
    sigma = max(float(sigma), 1e-2)
    radius = max(int(math.ceil(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)
    return (k / np.sum(k)).astype(np.float32)


def _shift_sum_1d(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Convolve along `axis` with replicate padding via shifted adds."""
    radius = (len(taps) - 1) // 2
    n = img.shape[axis]
    idx = torch.arange(-radius, n + radius, device=img.device).clamp_(0, n - 1)
    padded = img.index_select(axis, idx)
    out = torch.zeros_like(img)
    for i, t in enumerate(taps):
        out = out + t * padded.narrow(axis, i, n)
    return out


def gaussian_smooth(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian smoothing of an (H, W, C) or (H, W) image."""
    img = img.to(torch.float32)
    # 0-d float32 tensors keep each product in float32, as the reference's
    # jnp.float32(t) * plane does.
    taps = [torch.tensor(t, dtype=torch.float32, device=img.device)
            for t in gaussian_kernel_1d(sigma)]
    out = _shift_sum_1d(img, taps, axis=0)
    return _shift_sum_1d(out, taps, axis=1)


_SOBEL_D = (1.0, 0.0, -1.0)   # derivative taps
_SOBEL_S = (1.0, 2.0, 1.0)    # smoothing taps


def sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude of an (H, W, C) or (H, W) image -> (H, W)
    float32 (the superpixel path's edge strength). Colour images are
    reduced to luma first, with float32 constants in the reference's
    order; the root is the float64 one rounded once (torch's CPU float32
    `sqrt` is not correctly rounded, see `grid_graph.edge_weight_planes`)."""
    img = img.to(torch.float32)
    if img.ndim == 3:
        if img.shape[-1] == 3:
            gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                    + 0.114 * img[..., 2])
        else:
            gray = img[..., 0]
            for c in range(1, img.shape[-1]):
                gray = gray + img[..., c]
            gray = gray / img.shape[-1]
    else:
        gray = img

    def taps(t):
        return [torch.tensor(x, dtype=torch.float32, device=img.device)
                for x in t]

    gx = _shift_sum_1d(_shift_sum_1d(gray, taps(_SOBEL_D), axis=1),
                       taps(_SOBEL_S), axis=0)
    gy = _shift_sum_1d(_shift_sum_1d(gray, taps(_SOBEL_D), axis=0),
                       taps(_SOBEL_S), axis=1)
    return torch.sqrt((gx * gx + gy * gy).double()).float()

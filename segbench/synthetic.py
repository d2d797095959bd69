"""Frame content, frozen: the benchmark's own copy of the program's
synthetic generators (`gseg_tpu_torch/utils/synthetic.py`), so that the
yardstick does not move when the program's copy does. For the same
arguments each function returns the same bytes as the program's
(`segbench/tests/test_segbench_reference.py` holds them equal).

`bsds_like_image` is the image half of `bsds_like_scene`: the same draws
in the same order, stopping before the pseudo ground truths, which the
benchmark does not use.
"""

from __future__ import annotations

import numpy as np


def blobs_image(h: int, w: int, num_blobs: int = 6, noise: float = 8.0,
                seed: int = 0) -> np.ndarray:
    """Piecewise-constant colored voronoi blobs + Gaussian noise, uint8."""
    rng = np.random.default_rng(seed)
    own = blobs_ground_truth(h, w, num_blobs, seed)
    palette = rng.integers(0, 256, (num_blobs, 3))
    if h * w > 1 << 22:
        # large images: float32 noise halves host memory and time.
        img = palette[own].astype(np.float32)
        img += rng.standard_normal(img.shape, dtype=np.float32) * np.float32(noise)
        return np.clip(img, 0, 255).astype(np.uint8)
    img = palette[own].astype(np.float64)
    img += rng.normal(0.0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def blobs_ground_truth(h: int, w: int, num_blobs: int = 6, seed: int = 0
                       ) -> np.ndarray:
    """Nearest-center (voronoi) blob id map, O(H*W) memory.

    Small shapes use a running argmin in float64; large ones a chunked
    float32 GEMM argmin (the two round differently near ties, so the switch
    point is part of the image definition)."""
    rng = np.random.default_rng(seed)
    cy = rng.uniform(0, h, num_blobs)
    cx = rng.uniform(0, w, num_blobs)
    if h * w > 1 << 22:
        c = np.stack([cy, cx]).astype(np.float32)          # (2, B)
        c2 = (c[0] ** 2 + c[1] ** 2).astype(np.float32)    # (B,)
        own = np.empty((h, w), np.int32)
        xs = np.arange(w, dtype=np.float32)
        rows_per_chunk = max((1 << 24) // max(num_blobs * w, 1), 1)
        for y0 in range(0, h, rows_per_chunk):
            y1 = min(y0 + rows_per_chunk, h)
            ys = np.arange(y0, y1, dtype=np.float32)
            p = np.empty(((y1 - y0) * w, 2), np.float32)
            p[:, 0] = np.repeat(ys, w)
            p[:, 1] = np.tile(xs, y1 - y0)
            score = p @ c                                  # (chunk, B)
            score *= -2.0
            score += c2[None, :]
            own[y0:y1] = np.argmin(score, axis=1).reshape(y1 - y0, w)
        return own
    yy, xx = np.mgrid[0:h, 0:w]
    yy = yy.astype(np.float64)
    xx = xx.astype(np.float64)
    best = np.full((h, w), np.inf, np.float64)
    own = np.zeros((h, w), np.int32)
    for i in range(num_blobs):
        d = (yy - cy[i]) ** 2 + (xx - cx[i]) ** 2
        closer = d < best
        best[closer] = d[closer]
        own[closer] = i
    return own


def textured_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Photo-like content: multi-octave value noise, a global illumination
    gradient and per-pixel sensor noise, uint8."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((h, w, 3), np.float64)
    amp = 1.0
    cells = 8
    while cells <= max(h, w) // 4:
        gh, gw = min(cells, h), min(cells, w)
        lattice = rng.uniform(-1.0, 1.0, (gh + 1, gw + 1, 3))
        yy = np.linspace(0, gh, h, endpoint=False)
        xx = np.linspace(0, gw, w, endpoint=False)
        y0 = yy.astype(int)
        x0 = xx.astype(int)
        fy = (yy - y0)[:, None, None]
        fx = (xx - x0)[None, :, None]
        a = lattice[y0][:, x0]
        b = lattice[y0][:, x0 + 1]
        c = lattice[y0 + 1][:, x0]
        d = lattice[y0 + 1][:, x0 + 1]
        acc += amp * ((a * (1 - fx) + b * fx) * (1 - fy)
                      + (c * (1 - fx) + d * fx) * fy)
        amp *= 0.55
        cells *= 2
    acc /= max(np.abs(acc).max(), 1e-9)
    img = 128.0 + 96.0 * acc
    yy, xx = np.mgrid[0:h, 0:w]
    img += (20.0 * yy / max(h - 1, 1) - 10.0)[..., None]
    img += rng.normal(0.0, 3.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def bsds_like_image(h: int = 321, w: int = 481, n_regions: int = 90,
                    seed: int = 0) -> np.ndarray:
    """The image of `bsds_like_scene(h, w, n_regions, seed)`: a fine
    voronoi partition with per-region colours drawn from shared anchors,
    per-region texture over multi-octave value noise, an illumination
    gradient and sensor noise, uint8 (h, w, 3)."""
    rng = np.random.default_rng(seed)
    fine = blobs_ground_truth(h, w, num_blobs=n_regions, seed=seed)
    ids, fine = np.unique(fine, return_inverse=True)
    fine = fine.reshape(h, w).astype(np.int32)
    r = len(ids)
    anchors = rng.uniform(25, 230, (8, 3))
    base = (anchors[rng.integers(0, 8, r)]
            + rng.uniform(-14, 14, (r, 3)))
    tex_amp = rng.uniform(2.0, 40.0, r)
    noise = textured_image(h, w, seed=seed + 10000).astype(np.float64)
    noise -= noise.mean()
    img = base[fine]
    img += noise * (tex_amp[fine] / 96.0)[..., None]
    yy = np.arange(h, dtype=np.float64)[:, None, None]
    img += 18.0 * yy / max(h - 1, 1) - 9.0
    img += rng.normal(0.0, 2.5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)

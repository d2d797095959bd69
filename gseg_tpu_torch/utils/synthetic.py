"""Synthetic test/benchmark images in NumPy (port of
`gseg_tpu.utils.synthetic`). Images are deterministic functions of
(shape, seed) and byte-equal to the reference's."""

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


def bsds_like_scene(h: int = 321, w: int = 481, n_regions: int = 90,
                    seed: int = 0, n_gts: int = 5):
    """Photo-like scene at BSDS500 scale with MULTIPLE pseudo-ground-truths.

    BSDS500 is not part of the repository (the reference, README.md:21,
    benchmarks it at 481x321 with several human annotations per image).
    This is a stand-in built to the same *protocol shape*; image and
    ground truths are byte-equal to `gseg_tpu`'s for the same arguments:

      - image: a fine voronoi partition (~n_regions cells, the scale of the
        finest human annotation) rendered with per-region base color,
        per-region texture amplitude over shared multi-octave value noise,
        a global illumination gradient, and sensor noise — so edges exist
        at many contrasts and regions are NOT piecewise constant;
      - ground truths: `n_gts` label maps at geometrically coarser
        granularities, produced by greedy agglomerative merging of the fine
        partition's region-adjacency graph by mean-color distance —
        mimicking annotators that group perceptually similar regions at
        different levels of detail (BSDS human GTs likewise vary mainly in
        granularity). The scorer picks the ASA-maximizing one, exactly as
        the reference comparetool does (report-extract.txt:608-611).

    Returns (image uint8 (h, w, 3), [gt int32 (h, w)] coarse->fine).
    """
    rng = np.random.default_rng(seed)
    fine = blobs_ground_truth(h, w, num_blobs=n_regions, seed=seed)
    # some centers may own zero pixels; compact ids so stats line up.
    ids, fine = np.unique(fine, return_inverse=True)
    fine = fine.reshape(h, w).astype(np.int32)
    r = len(ids)
    # anchor-palette colors: regions draw from ~8 shared anchors + jitter,
    # so many ADJACENT regions are nearly iso-color. BSDS human boundaries
    # frequently sit on weak or semantic (non-color) edges; without this
    # structure every GT boundary is a strong color edge and all
    # algorithms score a ceiling ASA ~1.000 (measured) — no discrimination.
    anchors = rng.uniform(25, 230, (8, 3))
    base = (anchors[rng.integers(0, 8, r)]
            + rng.uniform(-14, 14, (r, 3)))
    tex_amp = rng.uniform(2.0, 40.0, r)       # smooth .. strongly textured
    noise = textured_image(h, w, seed=seed + 10000).astype(np.float64)
    noise -= noise.mean()
    img = base[fine]
    img += noise * (tex_amp[fine] / 96.0)[..., None]
    yy = np.arange(h, dtype=np.float64)[:, None, None]
    img += 18.0 * yy / max(h - 1, 1) - 9.0
    img += rng.normal(0.0, 2.5, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)

    # region adjacency from the fine partition (4-connectivity)
    a = np.concatenate([fine[:, :-1].ravel(), fine[:-1, :].ravel()])
    b = np.concatenate([fine[:, 1:].ravel(), fine[1:, :].ravel()])
    m = a != b
    pairs = np.unique(
        np.stack([np.minimum(a[m], b[m]), np.maximum(a[m], b[m])], 1), axis=0
    )
    # single-linkage agglomerative merge by base-color distance of adjacent
    # regions (Kruskal over the region-adjacency graph); snapshot the
    # partition at geometrically spaced region counts (coarse annotators).
    parent = np.arange(r)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    cost = np.linalg.norm(base[pairs[:, 0]] - base[pairs[:, 1]], axis=1)
    order = np.argsort(cost, kind="stable")
    # clamp at >=5 regions: human BSDS annotations have ~5-50 segments, and
    # a 2-region GT would let the ASA-maximizing picker trivially inflate
    # coarse segmentations' scores.
    targets = sorted({max(5, r // (2 ** (i + 1))) for i in range(n_gts)})
    gts = []
    live = r
    oi = 0
    while targets and oi < len(order):
        pa, pb = pairs[order[oi]]
        oi += 1
        ra, rb = find(pa), find(pb)
        if ra == rb:
            continue
        parent[rb] = ra
        live -= 1
        if live == targets[-1]:
            targets.pop()
            root = np.array([find(i) for i in range(r)], np.int32)
            gts.append(root[fine])
    # if adjacency ran dry before the coarsest target, keep what we have;
    # always include the fine partition itself as the finest annotator.
    gts.append(fine.copy())
    # annotator boundary imprecision: human BSDS boundaries do not coincide
    # with color edges (semantics, hand-drawn contours), so each pseudo-GT
    # is sampled through its own smooth ~±2 px displacement field. Without
    # this every algorithm scores a ceiling ASA ~0.999 (the GTs are exactly
    # the rendered partition); with it there is an irreducible boundary-
    # band error like BSDS's, and algorithm differences stay visible.
    yy0, xx0 = np.mgrid[0:h, 0:w]
    gts = [_warp_labels(g, yy0, xx0, amp=4.0,
                        rng=np.random.default_rng(seed * 1000 + 77 + i))
           for i, g in enumerate(gts)]
    gts.sort(key=lambda g: len(np.unique(g)))   # coarse -> fine
    return img, gts


def _smooth_field(h, w, cells, rng):
    """Bilinearly upsampled uniform[-1,1] lattice — one smooth channel."""
    lat = rng.uniform(-1.0, 1.0, (cells + 1, cells + 1))
    yy = np.linspace(0, cells, h, endpoint=False)
    xx = np.linspace(0, cells, w, endpoint=False)
    y0 = yy.astype(int)
    x0 = xx.astype(int)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    a = lat[y0][:, x0]
    b = lat[y0][:, x0 + 1]
    c = lat[y0 + 1][:, x0]
    d = lat[y0 + 1][:, x0 + 1]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def _warp_labels(g, yy0, xx0, amp, rng):
    h, w = g.shape
    dy = np.rint(amp * _smooth_field(h, w, 12, rng)).astype(np.int64)
    dx = np.rint(amp * _smooth_field(h, w, 12, rng)).astype(np.int64)
    ys = np.clip(yy0 + dy, 0, h - 1)
    xs = np.clip(xx0 + dx, 0, w - 1)
    return g[ys, xs].astype(np.int32)


def gradient_image(h: int, w: int) -> np.ndarray:
    """Smooth diagonal RGB gradient, uint8 (no edges)."""
    yy, xx = np.mgrid[0:h, 0:w]
    r = (255 * yy / max(h - 1, 1)).astype(np.uint8)
    g = (255 * xx / max(w - 1, 1)).astype(np.uint8)
    b = ((r.astype(int) + g.astype(int)) // 2).astype(np.uint8)
    return np.stack([r, g, b], axis=-1)


def checkerboard_image(h: int, w: int, cell: int = 8) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    c = ((yy // cell + xx // cell) % 2).astype(np.uint8) * 255
    return np.stack([c, c, c], axis=-1)

"""Implicit 8-connected grid graph over an image (port of
`gseg_tpu.ops.grid_graph`).

Conventions (shared with the reference, so tests compare like with like):
  - canonical directions d in [0, 4): E (0, 1), S (1, 0), SE (1, 1),
    NE (1, -1); edge id eid = anchor_vertex * 4 + d;
  - the 8-direction incident view lists the 4 canonical directions first,
    then their reverses (W, N, NW, SW);
  - weights are float32 (4, H, W) planes with +inf on invalid slots.
"""

from __future__ import annotations

import numpy as np
import torch

DIRS4 = ((0, 1), (1, 0), (1, 1), (1, -1))
DIRS8 = DIRS4 + tuple((-dy, -dx) for dy, dx in DIRS4)

INT32_MAX = int(np.iinfo(np.int32).max)


def flat_offsets(width: int) -> tuple[int, int, int, int]:
    """Flat-index offset of the second endpoint per canonical direction."""
    return tuple(dy * width + dx for dy, dx in DIRS4)


def shift_plane(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = x[y+dy, x+dx] where in-bounds, else `fill` (leading two
    axes are the image axes)."""
    h, w = x.shape[0], x.shape[1]
    out = torch.full_like(x, fill)
    ys, yd = (slice(dy, h), slice(0, h - dy)) if dy >= 0 else (
        slice(0, h + dy), slice(-dy, h))
    xs, xd = (slice(dx, w), slice(0, w - dx)) if dx >= 0 else (
        slice(0, w + dx), slice(-dx, w))
    out[yd, xd] = x[ys, xs]
    return out


def valid_plane(h: int, w: int, dy: int, dx: int, device=None) -> torch.Tensor:
    """Bool (h, w): True where the neighbor at (dy, dx) is in-bounds."""
    ones = torch.ones((h, w), dtype=torch.bool, device=device)
    return shift_plane(ones, dy, dx, False)


def edge_weight_planes(img: torch.Tensor, connectivity: int = 8,
                       quantize_bits: int = 0):
    """Canonical edge-weight planes of the implicit grid graph.

    img: (H, W, C) float32 (already smoothed). Returns (weights (4, H, W)
    float32 with +inf on invalid slots, valid (4, H, W) bool). With
    connectivity=4 the diagonal planes are all-invalid.
    """
    img = img.to(torch.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w = img.shape[0], img.shape[1]
    planes, valids = [], []
    ndirs = 4 if connectivity == 8 else 2
    for d, (dy, dx) in enumerate(DIRS4):
        if d < ndirs:
            diff = img - shift_plane(img, dy, dx, 0.0)
            sq = diff * diff
            # channel sum written out left to right: one fixed order on
            # every device.
            acc = sq[..., 0]
            for c in range(1, sq.shape[-1]):
                acc = acc + sq[..., c]
            # torch's float32 sqrt on the CPU is not correctly rounded; the
            # float64 root rounded once to float32 is (53 >= 2*24 + 2).
            wt = torch.sqrt(acc.double()).float()
            va = valid_plane(h, w, dy, dx, img.device)
        else:
            wt = torch.zeros((h, w), dtype=torch.float32, device=img.device)
            va = torch.zeros((h, w), dtype=torch.bool, device=img.device)
        planes.append(wt)
        valids.append(va)
    weights = torch.stack(planes)
    valid = torch.stack(valids)
    if quantize_bits:
        # float32 throughout, as the reference's jnp scalar arithmetic.
        scale = np.float32(2 ** quantize_bits - 1) / (
            np.sqrt(np.float32(3.0)) * np.float32(255.0))
        scale = torch.tensor(scale, dtype=torch.float32, device=img.device)
        weights = torch.round(weights * scale) / scale
    weights = torch.where(valid, weights, torch.inf)
    return weights, valid


def incident_views(weights: torch.Tensor):
    """8-direction incident edge view per vertex.

    weights: (4, H, W) canonical planes (+inf invalid). Returns (w8 (8, H, W)
    float32, +inf where absent; eid8 (8, H, W) int32, INT32_MAX where
    absent). For the reversed direction d+4 the neighbor at (-dy, -dx) is
    the anchor.
    """
    _, h, w = weights.shape
    vid = torch.arange(h * w, dtype=torch.int32,
                       device=weights.device).reshape(h, w)
    w8, eid8 = [], []
    for d in range(4):
        w8.append(weights[d])
        eid8.append(torch.where(torch.isfinite(weights[d]), vid * 4 + d,
                                INT32_MAX))
    for d, (dy, dx) in enumerate(DIRS4):
        wt = shift_plane(weights[d], -dy, -dx, torch.inf)
        anchor = shift_plane(vid, -dy, -dx, 0)
        w8.append(wt)
        eid8.append(torch.where(torch.isfinite(wt), anchor * 4 + d,
                                INT32_MAX))
    return torch.stack(w8), torch.stack(eid8)


def edge_endpoints(eid: torch.Tensor, width: int):
    """Decode canonical edge ids into (endpoint_a, endpoint_b) flat int32
    indices. Invalid ids (INT32_MAX) decode to in-range dummies; callers
    mask on validity themselves."""
    offs = torch.tensor(flat_offsets(width), dtype=torch.int32,
                        device=eid.device)
    safe = torch.where(eid == INT32_MAX, 0, eid)
    a = torch.div(safe, 4, rounding_mode="floor")
    d = safe - 4 * a
    return a, a + offs[d.to(torch.int64)]


def edge_list(weights: torch.Tensor, valid: torch.Tensor):
    """The static-size edge list: (src, dst, w, valid_flat), each (4*H*W,),
    where edge i has canonical id i (src*4 + d). Invalid slots get w = +inf
    and src = dst = 0."""
    _, h, w = weights.shape
    vid = torch.arange(h * w, dtype=torch.int32,
                       device=weights.device).reshape(h, w)
    offs = flat_offsets(w)
    src = torch.stack([torch.where(valid[d], vid, 0) for d in range(4)], -1)
    dst = torch.stack([torch.where(valid[d], vid + offs[d], 0)
                       for d in range(4)], -1)
    return (src.reshape(-1), dst.reshape(-1),
            torch.stack([weights[d] for d in range(4)], -1).reshape(-1),
            torch.stack([valid[d] for d in range(4)], -1).reshape(-1))

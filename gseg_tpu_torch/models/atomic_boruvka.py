"""Atomic-path Boruvka-Felzenszwalb segmentation (port of
`gseg_tpu/models/atomic_boruvka.py`).

Each Boruvka round over the implicit 8-connected grid graph:
  1. per-vertex min outgoing edge: eight shifted root planes and a
     min-reduce (ties to the smallest canonical edge id);
  2. per-component min edge: a two-phase scatter-min
     (`ops.primitives.component_min_edge`);
  3. the Felzenszwalb predicate in multiply form, (w - Int(C)) * |C| <= k
     on both sides (min-size rounds: |C| < min_size);
  4. 2-cycles removed, hook chains flattened by pointer doubling, sizes
     summed and Int(C) maxed into the new roots.
The reference has no Pallas kernel on this path: its rounds are XLA
scatters and gathers, and here they are plain torch ops on the device,
like the turbo path's stage 2.

Labels are root vertex ids (the root a component's hook chain ends in),
byte-equal to the reference's, not canonical min-vertex ids: use
`utils.labels.canonical_min_labels_np` to compare partitions.

Every `lax.while_loop` / `fori_loop` of the reference is a host loop that
reads the round's `merged` flag once per round. So `segment_atomic` (the
reference's on-device loop) and `segment_atomic_hostsync` (its host-synced
loop, one 4-byte read per round) run the same loop here; control of the
loop on the device is later work (ROADMAP.md, queue 1, item 2).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SegmentationConfig
from ..ops import filters
from ..ops import grid_graph as gg
from ..ops.primitives import (
    INT32_MAX,
    component_min_edge,
    pointer_double,
    remove_mutual_hooks,
    scatter_drop,
    segment_max,
    segment_sum,
)


class BoruvkaState(NamedTuple):
    parent: torch.Tensor   # (V,) int32, flattened (parent[v] == root)
    size: torch.Tensor     # (V,) int32, valid at root slots
    intdiff: torch.Tensor  # (V,) float32, valid at root slots
    merged: bool           # did the last round merge anything
    it: int


def _vertex_min_edge(w8, eid8, roots2d, nbr=None):
    """Per-vertex min outgoing edge: (vminw (V,), veid (V,)), +inf /
    INT32_MAX where every neighbour is in the same component. nbr: the
    (8, H, W) neighbour roots, where they come from beyond roots2d (a row
    tile's halo); None: shifts of roots2d."""
    if nbr is None:
        nbr = torch.stack([gg.shift_plane(roots2d, dy, dx, -1)
                           for dy, dx in gg.DIRS8])
    outgoing = torch.where(nbr != roots2d[None], w8, torch.inf)
    vminw = outgoing.amin(0)
    veid = torch.where(outgoing == vminw[None], eid8, INT32_MAX).amin(0)
    veid = torch.where(torch.isfinite(vminw), veid, INT32_MAX)
    return vminw.reshape(-1), veid.reshape(-1)


def _round(state: BoruvkaState, w8, eid8, shape, k, min_size,
           mode: str) -> BoruvkaState:
    """One Boruvka round. mode: "felz" (predicate-gated) or "minsize"."""
    h, w = shape
    v = h * w
    vminw, veid = _vertex_min_edge(w8, eid8, state.parent.reshape(h, w))
    comp_minw, comp_eid = component_min_edge(state.parent, vminw, veid, v)
    return _hook_round(state, comp_minw, comp_eid, w, k, min_size, mode)


def _hook_round(state: BoruvkaState, comp_minw, comp_eid, w, k, min_size,
                mode: str) -> BoruvkaState:
    """The rest of a round from each component's min edge (steps 3-4):
    everything but the per-vertex scan and the component min, which the
    row-sharded path (`parallel.spatial`) computes over its ranks."""
    parent, size, intdiff = state.parent, state.size, state.intdiff
    v = parent.numel()
    arange = torch.arange(v, dtype=torch.int32, device=parent.device)
    has = comp_eid != INT32_MAX

    a, b = gg.edge_endpoints(comp_eid, w)
    ra, rb = parent[a.to(torch.int64)], parent[b.to(torch.int64)]
    other = torch.where(ra == arange, rb, ra)
    oth = other.to(torch.int64)

    if mode == "felz":
        # (w - Int) * |C| <= k in float32, division-free; invalid lanes
        # (inf, or nan at stale size-0 slots) are masked by `has`.
        kf = torch.tensor(k, dtype=torch.float32, device=parent.device)
        lhs_self = (comp_minw - intdiff) * size.to(torch.float32)
        lhs_other = (comp_minw - intdiff[oth]) * size[oth].to(torch.float32)
        ok = (lhs_self <= kf) & (lhs_other <= kf)
    elif mode == "minsize":
        ok = size < min_size
    else:
        raise ValueError(mode)
    hook = has & ok

    succ = remove_mutual_hooks(torch.where(hook, other, arange))
    used = succ != arange

    parent_new = pointer_double(succ)[parent.to(torch.int64)]

    is_root = parent == arange
    size_new = segment_sum(torch.where(is_root, size, 0), parent_new, v)
    intdiff_new = segment_max(torch.where(is_root, intdiff, 0.0), parent_new,
                              v, fill=0.0)
    # used hook edges contribute their weight to the new root's Int.
    intdiff_new = scatter_drop(intdiff_new, parent_new,
                               torch.where(used, comp_minw, 0.0), "amax")
    return BoruvkaState(parent=parent_new, size=size_new,
                        intdiff=intdiff_new, merged=bool(used.any()),
                        it=state.it + 1)


def _init_state(v: int, device) -> BoruvkaState:
    return BoruvkaState(
        parent=torch.arange(v, dtype=torch.int32, device=device),
        size=torch.ones((v,), dtype=torch.int32, device=device),
        intdiff=torch.zeros((v,), dtype=torch.float32, device=device),
        merged=True, it=0)


def _run_phase(state, w8, eid8, shape, k, min_size, mode, max_iters):
    """Rounds until one merges nothing or `max_iters` rounds ran."""
    state = state._replace(merged=True, it=0)
    while state.merged and state.it < max_iters:
        state = _round(state, w8, eid8, shape, k, min_size, mode)
    return state


def prepare_graph(image: torch.Tensor, cfg: SegmentationConfig):
    """Smoothing and the implicit graph's incident views (w8, eid8)."""
    smoothed = filters.gaussian_smooth(image, cfg.sigma)
    weights, _ = gg.edge_weight_planes(smoothed, cfg.connectivity,
                                       cfg.quantize_weight_bits)
    return gg.incident_views(weights)


def _as_tensor(image):
    if isinstance(image, torch.Tensor):
        return image
    return torch.as_tensor(np.asarray(image))


def segment_atomic_impl(image, cfg: SegmentationConfig) -> torch.Tensor:
    """Smooth -> implicit graph -> Boruvka-Felzenszwalb rounds -> min-size
    rounds, on the image's device. Returns (H, W) int32 labels (root vertex
    ids)."""
    image = _as_tensor(image)
    h, w = image.shape[0], image.shape[1]
    w8, eid8 = prepare_graph(image, cfg)
    state = _run_phase(_init_state(h * w, image.device), w8, eid8, (h, w),
                       cfg.k, cfg.min_size, "felz", cfg.max_iters)
    if cfg.min_size > 1:
        state = _run_phase(state, w8, eid8, (h, w), cfg.k, cfg.min_size,
                           "minsize", cfg.max_iters)
    return state.parent.reshape(h, w)


segment_atomic = segment_atomic_impl


def segment_atomic_hostsync(image, cfg: SegmentationConfig) -> torch.Tensor:
    """The reference's host-synced variant (its conventional mode: one
    4-byte device-to-host read per round). In the port every round loop
    reads `merged` on the host, so this is `segment_atomic`."""
    return segment_atomic_impl(image, cfg)


def segment_atomic_hierarchy(image, cfg: SegmentationConfig):
    """Atomic path with a label capture after every felz round.

    Returns (levels, labels): levels (max_iters + 1, H, W) int32, the
    label map before round 1 and after each felz round (rows past
    convergence repeat the final felz map), and the final labels after the
    min-size rounds. The level tensor stays on the image's device."""
    image = _as_tensor(image)
    h, w = image.shape[0], image.shape[1]
    v = h * w
    w8, eid8 = prepare_graph(image, cfg)
    state = _init_state(v, image.device)
    levels = torch.empty((cfg.max_iters + 1, v), dtype=torch.int32,
                         device=image.device)
    levels[0] = state.parent
    for i in range(cfg.max_iters):
        if state.merged:
            state = _round(state, w8, eid8, (h, w), cfg.k, cfg.min_size,
                           "felz")
        levels[i + 1] = state.parent
    if cfg.min_size > 1:
        state = _run_phase(state, w8, eid8, (h, w), cfg.k, cfg.min_size,
                           "minsize", cfg.max_iters)
    return levels.reshape(cfg.max_iters + 1, h, w), state.parent.reshape(h, w)

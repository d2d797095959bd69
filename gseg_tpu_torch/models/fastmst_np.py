"""NumPy data-parallel-primitive prototypes (port of
`gseg_tpu.models.fastmst_np`): executable specifications of the FastMST
path, copied so that the port keeps its own oracles on a machine without
jax.

  fastmst_round_np    one Boruvka round as the DPP sequence (lexsort of
                      (component, w, eid) edge keys, segmented min via run
                      heads, successor construction, 2-cycle removal,
                      pointer jumping, relabel)
  segment_fastmst_np  the pipeline, with the per-round hierarchy capture
                      (return_levels=True)
  superpixel_hierarchy_np
                      pure Boruvka rounds with the weights recomputed every
                      round from float64 colour sums (the superpixel spec)

Labels are byte-equal to the reference's. The superpixel spec's edge
strength comes from `boruvka_cpu.strength_planes_np` (the reference takes
it from its JAX model); its colour sums are float64 where the model's are
float32, so its partitions may differ from the model's on near-ties.
"""

from __future__ import annotations

import numpy as np

from ..config import SegmentationConfig
from .boruvka_cpu import (_edge_arrays, edge_weight_planes_np,
                          gaussian_smooth_np, strength_planes_np)

INT32_MAX = np.iinfo(np.int32).max


def _pointer_jump(succ: np.ndarray) -> np.ndarray:
    while True:
        nxt = succ[succ]
        if np.array_equal(nxt, succ):
            return succ
        succ = nxt


def fastmst_round_np(parent, size, intdiff, ea, eb, ew, eid, k, min_size,
                     mode):
    """One DPP Boruvka round; returns (parent', size', intdiff', merged)."""
    v = parent.shape[0]
    idx = np.arange(v, dtype=np.int64)
    # directed edge list, both orientations (adjacency-list analog)
    src = np.concatenate([parent[ea], parent[eb]])
    dst = np.concatenate([parent[eb], parent[ea]])
    w2 = np.concatenate([ew, ew])
    e2 = np.concatenate([eid, eid])
    live = src != dst
    key_src = np.where(live, src, np.int64(v))
    # DPP segmented min: lexsort by (src, w, eid), run heads are minima
    order = np.lexsort((e2, w2, key_src))
    s_src, s_dst = key_src[order], dst[order]
    s_w, s_e = w2[order], e2[order]
    head = np.r_[True, s_src[1:] != s_src[:-1]] & (s_src < v)

    comp = s_src[head]
    other = s_dst[head]
    cw = s_w[head].astype(np.float32)

    if mode == "felz":
        # Multiply-form predicate (w - Int)*|C| <= k — division-free; see
        # models/boruvka_cpu.py for the cross-backend ULP rationale. All
        # lanes here are live heads (size >= 1 at comp/other roots).
        kf = np.float32(k)
        sizef = size.astype(np.float32)
        ok = (((cw - intdiff[comp]) * sizef[comp] <= kf)
              & ((cw - intdiff[other]) * sizef[other] <= kf))
    else:
        ok = size[comp] < min_size

    succ = idx.copy()
    succ[comp[ok]] = other[ok]
    mutual = (succ[succ] == idx) & (succ != idx)
    succ = np.where(mutual & (idx < succ), idx, succ)
    used = succ != idx
    if not used.any():
        return parent, size, intdiff, False

    root = _pointer_jump(succ)
    parent_new = root[parent]
    is_root = parent == idx
    size_new = np.zeros(v, dtype=np.int64)
    np.add.at(size_new, parent_new[is_root], size[is_root])
    intdiff_new = np.zeros(v, dtype=np.float32)
    np.maximum.at(intdiff_new, parent_new[is_root], intdiff[is_root])
    # weights of surviving hooks
    hook_w = np.zeros(v, dtype=np.float32)
    hook_w[comp] = cw
    np.maximum.at(intdiff_new, parent_new[used], hook_w[used])
    return parent_new, size_new, intdiff_new, True


def segment_fastmst_np(image, cfg: SegmentationConfig, return_levels=False):
    """NumPy FastMST/DPP pipeline (P3) with optional hierarchy capture (P4)."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    sm = gaussian_smooth_np(image, cfg.sigma)
    weights, _ = edge_weight_planes_np(
        sm, cfg.connectivity, cfg.quantize_weight_bits
    )
    valid = np.isfinite(weights)
    ea, eb, ew, ev = _edge_arrays(weights, valid, w)
    live = np.nonzero(ev)[0]
    ea, eb, ew, eid = ea[live], eb[live], ew[live], live.astype(np.int64)

    parent = np.arange(v, dtype=np.int64)
    size = np.ones(v, dtype=np.int64)
    intdiff = np.zeros(v, dtype=np.float32)
    levels = [parent.astype(np.int32).copy()]
    for mode in ("felz", "minsize") if cfg.min_size > 1 else ("felz",):
        for _ in range(cfg.max_iters):
            parent, size, intdiff, merged = fastmst_round_np(
                parent, size, intdiff, ea, eb, ew, eid, cfg.k, cfg.min_size,
                mode,
            )
            if mode == "felz":
                levels.append(parent.astype(np.int32).copy())
            if not merged:
                break
    labels = parent.astype(np.int32).reshape(h, w)
    if return_levels:
        return np.stack(levels).reshape(-1, h, w), labels
    return labels


def superpixel_hierarchy_np(image, cfg: SegmentationConfig):
    """NumPy superpixel-hierarchy prototype: pure Boruvka rounds with
    weights recomputed each round as strength x ||avg colour diff||.
    Returns (levels (L, H, W), final labels)."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    sm = gaussian_smooth_np(image, cfg.sigma)
    weights, _ = edge_weight_planes_np(sm, cfg.connectivity)
    valid = np.isfinite(weights)
    ea, eb, _, ev = _edge_arrays(weights, valid, w)
    live = np.nonzero(ev)[0]
    ea, eb, eid = ea[live], eb[live], live.astype(np.int64)
    strength = strength_planes_np(sm).transpose(1, 2, 0).reshape(-1)[live]

    parent = np.arange(v, dtype=np.int64)
    size = np.ones(v, dtype=np.int64)
    colorsum = sm.reshape(v, -1).astype(np.float64).copy()
    levels = [parent.astype(np.int32).copy()]
    for _ in range(cfg.max_iters):
        avg = colorsum / np.maximum(size, 1)[:, None]
        diff = avg[parent[ea]] - avg[parent[eb]]
        ew = (strength * np.sqrt((diff * diff).sum(axis=1))).astype(np.float32)
        parent, size, colorsum, merged = _always_round(
            parent, size, colorsum, ea, eb, ew, eid)
        levels.append(parent.astype(np.int32).copy())
        if not merged:
            break
    return (np.stack(levels).reshape(-1, h, w),
            parent.astype(np.int32).reshape(h, w))


def _always_round(parent, size, colorsum, ea, eb, ew, eid):
    """Pure-Boruvka round (always merge) maintaining sizes and colour
    sums; returns (parent', size', colorsum', merged)."""
    v = parent.shape[0]
    idx = np.arange(v, dtype=np.int64)
    src = np.concatenate([parent[ea], parent[eb]])
    dst = np.concatenate([parent[eb], parent[ea]])
    w2 = np.concatenate([ew, ew])
    e2 = np.concatenate([eid, eid])
    live = src != dst
    key_src = np.where(live, src, np.int64(v))
    order = np.lexsort((e2, w2, key_src))
    s_src, s_dst = key_src[order], dst[order]
    head = np.r_[True, s_src[1:] != s_src[:-1]] & (s_src < v)
    comp, other = s_src[head], s_dst[head]

    succ = idx.copy()
    succ[comp] = other
    mutual = (succ[succ] == idx) & (succ != idx)
    succ = np.where(mutual & (idx < succ), idx, succ)
    if not (succ != idx).any():
        return parent, size, colorsum, False
    root = _pointer_jump(succ)
    parent_new = root[parent]
    is_root = parent == idx
    size_new = np.zeros(v, dtype=np.int64)
    np.add.at(size_new, parent_new[is_root], size[is_root])
    cs_new = np.zeros_like(colorsum)
    np.add.at(cs_new, parent_new[is_root], colorsum[is_root])
    colorsum[:] = cs_new
    return parent_new, size_new, colorsum, True

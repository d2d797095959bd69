"""DPP/FastMST segmentation path (port of `gseg_tpu/models/fastmst.py`).

The reference's data-parallel-primitive Boruvka schedule:

  ROUND 1 — dense, at pixel scale: with identity parents the component min
  edge is the pixel's min incident edge (a lexmin over the 8 incident
  planes); hooks, mutual-hook removal and pointer doubling on the (V,)
  successor array, sizes and Int by scatters.

  EXTRACTION — live boundary edges, deduplicated to the min (w, eid) edge
  per component pair by chunked sorts (`turbo._chunked_pair_extract`), at
  the capacities one round's handoff needs (pairs 1.25 V, components V/2).

  ROUNDS 2+ — the compact rounds of the turbo path's stage 2
  (`turbo._s2_round` with canonical=False): one round, recompact to V, two
  rounds, recompact to V/4, then the run-out to convergence with the
  min-size rounds, on a V/16 slice of the pool when every live pair fits.

  FINAL — each round-1 root's final root is placed on its root pixel and
  value-flooded over the round-1 components (`kernels.gossip.value_flood`,
  the hand-written step kernel; the hybrid route, as the reference's
  `_final_map` default).

Labels are hook-sink root vertex ids: byte-equal to `segment_atomic` and
the NumPy oracles, where turbo gives canonical min-vertex ids; the
partition equals turbo's. Every `lax.while_loop` / `lax.cond` of the
reference is a host loop or `if`.
"""

from __future__ import annotations

import torch

from ..config import SegmentationConfig
from ..ops import filters
from ..ops import grid_graph as gg
from ..ops.kernels import gossip as kg
from ..ops.primitives import (
    INT32_MAX,
    pointer_double,
    remove_mutual_hooks,
    scatter_drop,
    segment_sum,
)
from . import turbo

_FLOOR = 16384   # the reference's capacity floor on this path


def _round1_dense(image: torch.Tensor, cfg: SegmentationConfig):
    """The first Boruvka-Felzenszwalb round at pixel scale. Returns (gst:
    turbo.GossipState with hook-sink labels and stats after round 1,
    weights (4, H, W))."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    dev = image.device
    smoothed = filters.gaussian_smooth(image, cfg.sigma)
    weights, _ = gg.edge_weight_planes(smoothed, cfg.connectivity,
                                       cfg.quantize_weight_bits)
    w8, eid8 = gg.incident_views(weights)
    vid = torch.arange(v, dtype=torch.int32, device=dev)

    # round-1 predicate: all sizes 1, Int 0, so both sides test w <= k.
    vminw = w8.amin(0)
    veid = torch.where(w8 == vminw[None], eid8, INT32_MAX).amin(0)
    ok = torch.isfinite(vminw) & (
        vminw <= torch.tensor(cfg.k, dtype=torch.float32, device=dev))
    a, b = gg.edge_endpoints(veid.reshape(-1), w)
    succ = remove_mutual_hooks(torch.where(ok.reshape(-1), a + b - vid, vid))
    used = succ != vid
    parent1 = pointer_double(succ)
    size1 = segment_sum(torch.ones(v, dtype=torch.int32, device=dev),
                        parent1, v)
    id1 = scatter_drop(torch.zeros(v, dtype=torch.float32, device=dev),
                       torch.where(used, parent1, v),
                       torch.where(used, vminw.reshape(-1), 0.0), "amax")
    gst = turbo.GossipState(
        L=parent1.reshape(h, w), S=size1.reshape(h, w), ID=id1.reshape(h, w),
        merged=bool(used.any()), it=1, bucket=0,
        flags=torch.zeros((), dtype=torch.int32, device=dev))
    return gst, weights


def boundary_pairs(L, w4, dead_inf=False):
    """The live boundary edges of a label plane (finite w4, labels apart,
    both ends in the image), deduplicated per pair by
    turbo._chunked_pair_extract at the pair cap 1.25 V: (lo, hi) labels of
    each canonical edge slot (INT32_MAX where dead) and its value w4 (eid
    order v * 4 + d; dead_inf: +inf on dead slots, as the superpixel path
    passes it). Returns its (mask, lo, hi, w, eid, overflow)."""
    v = L.numel()
    la = torch.stack([L] * 4, -1).reshape(-1)
    lb = torch.stack([gg.shift_plane(L, dy, dx, -1) for dy, dx in gg.DIRS4],
                     -1).reshape(-1)
    live = torch.isfinite(w4) & (la != lb) & (lb >= 0)
    if dead_inf:
        w4 = torch.where(live, w4, torch.inf)
    lo = torch.where(live, torch.minimum(la, lb), INT32_MAX)
    hi = torch.where(live, torch.maximum(la, lb), INT32_MAX)
    eid4 = torch.arange(4 * v, dtype=torch.int32, device=L.device)
    return turbo._chunked_pair_extract(lo, hi, w4, eid4,
                                       max(v + v // 4, _FLOOR))


def _extract_compact(gst, weights, v: int):
    """Dense planes -> deduped compact edge pool + root list + stats (pair
    cap 1.25 V and comp cap V/2: round-1 components are small, so distinct
    pairs run at about 1.05-1.10 V). Returns (st, rm, r0)."""
    w4 = torch.stack([weights[d] for d in range(4)], -1).reshape(-1)
    pm, plo, phi, pw, pe, pair_ovf = boundary_pairs(gst.L, w4)
    return turbo._pools_to_state(pm, plo, phi, pw, pe, pair_ovf, v,
                                 max(v // 2, _FLOOR), gst.S.reshape(-1),
                                 gst.ID.reshape(-1), 0, gst.flags)


def _compact_phase(st, v, cfg, rounds, runout=False, capture=None):
    """Compact felz rounds with hook-sink labels; the run-out phase goes on
    to the min-size rounds and flags an exhausted round budget."""
    return turbo._s2_phase(st, v, max(v // 2, _FLOOR), cfg.k, cfg.min_size,
                           rounds, None,
                           with_minsize=runout and cfg.min_size > 1,
                           flag_exhaustion=runout, capture=capture,
                           canonical=False)


def _early_rounds(st, v, cfg, capture=None):
    """One compact round at the entry pool, recompact to V, two rounds,
    recompact to V/4 (live pairs decay 3-4x a round)."""
    st = _compact_phase(st, v, cfg, 1, capture=capture)
    st, rec_ovf = turbo._recompact_edges(st, max(v, _FLOOR))
    st = _compact_phase(st, v, cfg, 2, capture=capture)
    st, rec2_ovf = turbo._recompact_edges(st, max(v // 4, _FLOOR))
    return st._replace(flags=turbo._raise_flag(
        st.flags, rec_ovf | rec2_ovf, turbo.FLAG_RECOMPACT_OVERFLOW))


def _runout(st, v, cfg, capture=None):
    """The rounds to convergence, then the min-size rounds."""
    return _compact_phase(st, v, cfg, 2 * cfg.max_iters, runout=True,
                          capture=capture)


def _compact_rounds(st, v, cfg):
    """All compact rounds: the early rounds, then the run-out. Sorts cost
    by capacity while live pairs keep decaying, so when every live pair
    fits a V/16 slice of the front-compacted pool the run-out runs on the
    slice (lossless); only fin and flags come back from it."""
    st = _early_rounds(st, v, cfg)
    cs = max(v // 16, _FLOOR)
    if (turbo._S2_SMALL and cs < st.esrc.numel()
            and int(torch.isfinite(st.ew).sum()) <= cs):
        out = _runout(st._replace(esrc=st.esrc[:cs], edst=st.edst[:cs],
                                  ew=st.ew[:cs], eeid=st.eeid[:cs]), v, cfg)
    else:
        out = _runout(st, v, cfg)
    return st._replace(fin=out.fin, flags=out.flags)


def segment_fastmst_impl(image: torch.Tensor, cfg: SegmentationConfig):
    """(H, W, 3) tensor -> (labels, flags): (H, W) int32 hook-sink root-id
    labels on the image's device and an int FLAG_* mask (turbo.FLAG_*)."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    gst, weights = _round1_dense(image, cfg)
    st, rm, r0 = _extract_compact(gst, weights, v)
    st = _compact_rounds(st, v, cfg)
    labels, fm_unconv = turbo._final_map(gst, st, rm, r0, 4 * (h + w),
                                         closures=True)
    flags = turbo._raise_flag(st.flags, fm_unconv,
                              turbo.FLAG_GOSSIP_UNCONVERGED)
    return labels, int(flags)


segment_fastmst_flagged = segment_fastmst_impl


def _violation(flags):
    return f"fastmst capacity/budget violation: {turbo.describe_flags(flags)}"


def segment_fastmst(image: torch.Tensor, cfg: SegmentationConfig):
    """Checked DPP entry: (H, W, 3) -> (H, W) int32 hook-sink root labels,
    byte-equal to segment_atomic's. On a nonzero flag mask, per
    cfg.on_overflow: raise RuntimeError ("raise"), return anyway
    ("ignore"), or route to the atomic path ("fallback")."""
    labels, flags = segment_fastmst_flagged(image, cfg)
    if flags == 0 or cfg.on_overflow == "ignore":
        return labels
    if cfg.on_overflow == "fallback":
        from .atomic_boruvka import segment_atomic

        return segment_atomic(image, cfg)
    raise RuntimeError(
        _violation(flags) + " — rerun with SegmentationConfig("
        "on_overflow='fallback') to route to the atomic path")


def segment_fastmst_hierarchy_impl(image: torch.Tensor,
                                   cfg: SegmentationConfig,
                                   n_levels: int | None = None):
    """(H, W, 3) tensor -> (levels (n_levels + 2, H, W), labels, flags).

    Level 0 is the identity, level 1 the dense round, levels 2.. the
    compact felz rounds rendered through the round-1 value flood (the
    min-size rounds refine the last level), levels past convergence
    repeating the last; labels the final map; flags an int FLAG_* mask.
    The shape differs from the other hierarchies (max_iters + 1 planes):
    the dense round is a plane of its own. n_levels: default
    cfg.max_iters. Levels stay on the device."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    if n_levels is None:
        n_levels = cfg.max_iters
    gst, weights = _round1_dense(image, cfg)
    st, rm, r0 = _extract_compact(gst, weights, v)
    fins, cur = [None] * n_levels, 0

    def on_felz(fin):
        nonlocal cur
        fins[min(cur, n_levels - 1)] = fin
        cur += 1

    st = _runout(_early_rounds(st, v, cfg, on_felz), v, cfg, on_felz)
    # unwritten slots repeat the last captured root map (no capture: the
    # initial root map).
    last = fins[min(cur, n_levels) - 1] if cur else torch.where(rm, r0, 0)
    fins = [f if i < cur else last for i, f in enumerate(fins)]

    max_sweeps = 4 * (h + w)
    vid2d = torch.arange(v, dtype=torch.int32,
                         device=image.device).reshape(h, w)
    seed_base = torch.where(gst.L == vid2d, gst.L, INT32_MAX).reshape(-1)
    rendered = {}  # a root map repeated past convergence renders once
    levels = torch.empty((n_levels + 2, h, w), dtype=torch.int32,
                         device=image.device)
    levels[0], levels[1] = vid2d, gst.L
    unconv = False
    for i, fin in enumerate(fins):
        if id(fin) not in rendered:
            seed = turbo._scatter(seed_base, r0, fin)  # r0 holds v past rm
            rendered[id(fin)] = kg.value_flood(
                gst.L, seed.reshape(h, w), max_sweeps, closures=True)
        levels[i + 2], lv_unconv = rendered[id(fin)]
        unconv = unconv or lv_unconv
    labels, fm_unconv = turbo._final_map(gst, st, rm, r0, max_sweeps,
                                         closures=True)
    flags = turbo._raise_flag(st.flags, unconv or fm_unconv,
                              turbo.FLAG_GOSSIP_UNCONVERGED)
    return levels, labels, int(flags)


segment_fastmst_hierarchy_flagged = segment_fastmst_hierarchy_impl


def segment_fastmst_hierarchy(image: torch.Tensor, cfg: SegmentationConfig):
    """DPP segmentation hierarchy: (levels (L, H, W), final labels (H, W)).
    On a nonzero flag mask, per cfg.on_overflow: raise RuntimeError,
    return anyway ("ignore"), or route to the atomic hierarchy
    ("fallback")."""
    levels, labels, flags = segment_fastmst_hierarchy_flagged(image, cfg)
    if flags == 0 or cfg.on_overflow == "ignore":
        return levels, labels
    if cfg.on_overflow == "fallback":
        from .atomic_boruvka import segment_atomic_hierarchy

        return segment_atomic_hierarchy(image, cfg)
    raise RuntimeError(_violation(flags))

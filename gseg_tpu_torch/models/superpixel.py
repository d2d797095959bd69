"""DPP superpixel hierarchy (port of `gseg_tpu/models/superpixel.py`).

The fastmst pipeline with the edge weights recomputed every Boruvka round
as

    w(u, v) = sobel_strength(u, v) * || avg_color(Cu) - avg_color(Cv) ||

and every component merging along its min outgoing edge (pure Boruvka, no
Felzenszwalb predicate), one hierarchy level per round. The only V-scale
round is the dense round 1; rounds 2+ run on the compact pair pool
(`fastmst.boundary_pairs`), which keeps each pair's min-(strength, eid)
edge: the colour term is common to a pair's edges, so that edge realises
the pair's min weight in every round. Sizes and colour sums live at the
components' root slots.

Two sums decide the bits of the weights, and follow the reference's
XLA:CPU arithmetic:
  - the colour sums add their rows one after another in update order
    (`kernels.scatter.ordered_scatter_add`: a hand-written CUDA helper on
    the card, the plain version on the CPU), so they are bit-equal to the
    reference's and the same on every run;
  - the colour distance: XLA:CPU contracts the round's squared distance
    into a chain of fused multiply-adds (d0*d0, then fma(d1, d1, .), then
    fma(d2, d2, .)); `_fma` reproduces each step rounded once, and the
    root is the float64 one rounded once.
Levels render through the value flood (`kernels.gossip.value_flood`, the
hand-written step kernel) over the round-1 components.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SegmentationConfig
from ..ops import filters
from ..ops import grid_graph as gg
from ..ops.kernels import gossip as kg
from ..ops.kernels import scatter as ks
from ..ops.primitives import (
    INT32_MAX,
    pointer_double,
    remove_mutual_hooks,
    segment_sum,
)
from . import turbo
from .fastmst import _FLOOR, boundary_pairs


class SPCompact(NamedTuple):
    esrc: torch.Tensor    # (E,) int32 current root of endpoint a
    edst: torch.Tensor    # (E,) int32
    estr: torch.Tensor    # (E,) float32 Sobel strength (+inf dead)
    eeid: torch.Tensor    # (E,) int32 canonical edge id (tie-break)
    SZf: torch.Tensor     # (V,) int32 sizes at root slots
    CSf: torch.Tensor     # (V, C) float32 colour sums at root slots
    fin: torch.Tensor     # (R,) int32 current root of each initial root
    merged: bool
    it: int
    flags: torch.Tensor   # () int32 FLAG_* bits


def _strength_planes(smoothed: torch.Tensor) -> torch.Tensor:
    """Per canonical edge plane (eid order v * 4 + d), the mean of its
    endpoints' Sobel magnitudes of the smoothed image: (4, H, W)."""
    sob = filters.sobel_magnitude(smoothed)
    return torch.stack([0.5 * (sob + gg.shift_plane(sob, dy, dx, 0.0))
                        for dy, dx in gg.DIRS4])


def _round1_dense(image: torch.Tensor, cfg: SegmentationConfig):
    """Dense pure-Boruvka round 1: weights strength x pixel colour
    distance, every pixel hooks along its min edge. Returns (L1 (H, W),
    sizes (V,), colour sums (V, C), strength (4, H, W), merged)."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    dev = image.device
    smoothed = filters.gaussian_smooth(image, cfg.sigma)
    weights, valid = gg.edge_weight_planes(smoothed, cfg.connectivity)
    strength = _strength_planes(smoothed)
    w8, eid8 = gg.incident_views(torch.where(valid, strength * weights,
                                             torch.inf))
    vid = torch.arange(v, dtype=torch.int32, device=dev)
    vminw = w8.amin(0)
    veid = torch.where(w8 == vminw[None], eid8, INT32_MAX).amin(0)
    a, b = gg.edge_endpoints(veid.reshape(-1), w)
    succ = remove_mutual_hooks(torch.where(torch.isfinite(vminw).reshape(-1),
                                           a + b - vid, vid))
    parent1 = pointer_double(succ)
    size1 = segment_sum(torch.ones(v, dtype=torch.int32, device=dev),
                        parent1, v)
    rows = smoothed.reshape(v, -1)
    csum1 = ks.ordered_scatter_add(rows.new_zeros(rows.shape), parent1, rows)
    return (parent1.reshape(h, w), size1, csum1, strength,
            bool((succ != vid).any()))


def _extract_compact(L1, strength, v: int):
    """Dense planes -> compact pair-deduped edge pool carrying strengths.
    Returns (esrc, edst, estr, eeid, fin, rm, r0, flags)."""
    s4 = torch.stack([strength[d] for d in range(4)], -1).reshape(-1)
    pm, plo, phi, ps, pe, pair_ovf = boundary_pairs(L1, s4, dead_inf=True)
    (esrc, edst, estr, eeid), rm, r0, root_ovf = turbo._pool_roots(
        pm, plo, phi, ps, pe, v, max(v // 2, _FLOOR))
    flags = turbo._raise_flag(turbo._raise_flag(
        torch.zeros((), dtype=torch.int32, device=L1.device), pair_ovf,
        turbo.FLAG_PAIR_OVERFLOW), root_ovf, turbo.FLAG_COMP_OVERFLOW)
    return esrc, edst, estr, eeid, torch.where(rm, r0, 0), rm, r0, flags


def _fma(a, b, c):
    """float32 fma(a, b, c), rounded once. The product is exact in float64
    (24 + 24 bits) and so is the float64 sum's rounding error (TwoSum);
    where that sum lands on a midpoint between two float32 values and the
    exact sum lies off it, the rounding goes toward the exact sum."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    rd = r.double()
    other = torch.nextafter(r, torch.where(s > rd, torch.inf, -torch.inf))
    mid = (s == (rd + other.double()) / 2) & (err != 0)
    up = (err > 0) == (other > r)
    return torch.where(mid & up, other, r)


def _colour_distance(da):
    """|| da || over the last axis as the reference's compiled round
    computes it: the squares summed as a chain of fused multiply-adds, the
    float64 root rounded once."""
    acc = da[:, 0] * da[:, 0]
    for c in range(1, da.shape[1]):
        acc = _fma(da[:, c], da[:, c], acc)
    return torch.sqrt(acc.double()).float()


def _sp_round(st: SPCompact, v: int, comp_cap: int) -> SPCompact:
    """One compact pure-Boruvka round with reweighting: the schedule of
    turbo._s2_round (sort by (component, w, eid), run-head minima, hook
    chains resolved in compact space, hook-sink labels), every head
    hooking, with sizes and colour sums merged into the sinks."""
    esrc, edst, estr = st.esrc, st.edst, st.estr
    live = (esrc != edst) & torch.isfinite(estr)
    avg = st.CSf / st.SZf.clamp(min=1).float()[:, None]
    da = (avg[esrc.to(torch.int64)] - avg[edst.to(torch.int64)])
    ew = torch.where(live, estr * _colour_distance(da), torch.inf)
    k1 = torch.where(live, esrc, INT32_MAX)
    perm = turbo._lexsort(turbo._key64(k1, ew), st.eeid)
    s_src, s_dst = k1[perm], edst[perm]
    head = turbo._run_heads(s_src) & (s_src != INT32_MAX)
    hm, (hsrc, hdst), head_ovf = turbo._select_compact(
        head, [s_src, s_dst], comp_cap)
    _, nr = turbo._hook_roots(hm, hsrc, torch.where(hm, hdst, hsrc), v)
    changed = hm & (nr != hsrc)

    iota = torch.arange(v, dtype=torch.int32, device=esrc.device)
    M = turbo._scatter(iota, torch.where(hm, hsrc, v), nr)
    tgt = torch.where(changed, nr, v)
    hsrc64 = hsrc.clamp(max=v - 1).to(torch.int64)  # past hm: masked
    SZf = turbo._scatter(st.SZf, tgt,
                         torch.where(changed, st.SZf[hsrc64], 0), "sum")
    CSf = ks.ordered_scatter_add(st.CSf, tgt, st.CSf[hsrc64])
    return SPCompact(
        esrc=M[esrc.to(torch.int64)], edst=M[edst.to(torch.int64)],
        estr=st.estr, eeid=st.eeid, SZf=SZf, CSf=CSf,
        fin=M[st.fin.to(torch.int64)], merged=bool(changed.any()),
        it=st.it + 1,
        flags=turbo._raise_flag(st.flags, head_ovf,
                                turbo.FLAG_COMP_OVERFLOW))


def _recompact(st: SPCompact, cap: int) -> SPCompact:
    o1, o2, ostr, oe, ovf = turbo._pair_dedup(st.esrc, st.edst, st.estr,
                                              st.eeid, cap)
    return st._replace(esrc=o1, edst=o2, estr=ostr, eeid=oe,
                       flags=turbo._raise_flag(
                           st.flags, ovf, turbo.FLAG_RECOMPACT_OVERFLOW))


def _run_rounds(image: torch.Tensor, cfg: SegmentationConfig, nrounds: int):
    """Round 1 dense and `nrounds` compact rounds, the pool recompacted to
    V/2 after the first compact round (the component count at least halves
    every round). Returns (L1, st, fins: the root map after each compact
    round, rm, r0); a round after one that merged nothing is skipped."""
    v = image.shape[0] * image.shape[1]
    L1, size1, csum1, strength, merged1 = _round1_dense(image, cfg)
    esrc, edst, estr, eeid, fin, rm, r0, xflags = _extract_compact(
        L1, strength, v)
    st = SPCompact(esrc=esrc, edst=edst, estr=estr, eeid=eeid, SZf=size1,
                   CSf=csum1, fin=fin, merged=merged1, it=0, flags=xflags)
    st, fins = _rounds(st, v, nrounds)
    return L1, st, fins, rm, r0


def _rounds(st: SPCompact, v: int, nrounds: int):
    """`nrounds` compact rounds from the entry state; returns (st, fins)."""
    fins = []
    for i in range(nrounds):
        if st.merged:
            st = _sp_round(st, v, max(v // 2, _FLOOR))
        fins.append(st.fin)
        if i == 0:
            st = _recompact(st, max(v // 2, _FLOOR))
    return st, fins


def _render(L1, fin, rm, r0):
    """Root map -> (H, W) labels: each round-1 root's root on its root
    pixel, value-flooded over the round-1 components (the hybrid route, as
    the reference's value_flood default). Returns (labels,
    unconverged)."""
    h, w = L1.shape
    vid2d = torch.arange(h * w, dtype=torch.int32,
                         device=L1.device).reshape(h, w)
    seed = torch.where(L1 == vid2d, L1, INT32_MAX).reshape(-1)
    seed = turbo._scatter(seed, r0, fin)  # r0 holds h * w past rm
    return kg.value_flood(L1, seed.reshape(h, w), 4 * (h + w), closures=True)


def segment_superpixel_hierarchy_impl(image: torch.Tensor,
                                      cfg: SegmentationConfig):
    """(H, W, 3) tensor -> (levels, final, flags): levels (max(max_iters,
    2) + 1, H, W) int32 on the image's device, level 0 the identity, level
    1 the dense round, level i + 1 compact round i; final the last level;
    flags an int FLAG_* mask. Levels stay on the device."""
    h, w = image.shape[0], image.shape[1]
    nrounds = max(cfg.max_iters - 1, 1)
    L1, st, fins, rm, r0 = _run_rounds(image, cfg, nrounds)
    levels = torch.empty((nrounds + 2, h, w), dtype=torch.int32,
                         device=image.device)
    levels[0] = torch.arange(h * w, dtype=torch.int32,
                             device=image.device).reshape(h, w)
    levels[1] = L1
    rendered = {}  # a round that merged nothing leaves the same root map
    unconv = False
    for i, fin in enumerate(fins):
        if id(fin) not in rendered:
            rendered[id(fin)] = _render(L1, fin, rm, r0)
        levels[i + 2], lv_unconv = rendered[id(fin)]
        unconv = unconv or lv_unconv
    flags = turbo._raise_flag(st.flags, unconv,
                              turbo.FLAG_GOSSIP_UNCONVERGED)
    return levels, levels[nrounds + 1], int(flags)


segment_superpixel_hierarchy_flagged = segment_superpixel_hierarchy_impl


def _check(flags: int, cfg: SegmentationConfig) -> None:
    if flags and cfg.on_overflow == "raise":
        raise RuntimeError("superpixel capacity/budget violation: "
                           f"{turbo.describe_flags(flags)}")


def segment_superpixel_hierarchy(image: torch.Tensor,
                                 cfg: SegmentationConfig):
    """Full superpixel hierarchy: (levels (max_iters + 1, H, W), final).
    Each level has at most half the superpixels of the one before, down to
    one. A nonzero flag mask raises RuntimeError unless cfg.on_overflow is
    "fallback" or "ignore" (the path has no fallback route: both return
    the levels)."""
    levels, final, flags = segment_superpixel_hierarchy_flagged(image, cfg)
    _check(flags, cfg)
    return levels, final


def segment_superpixel_impl(image: torch.Tensor, cfg: SegmentationConfig):
    """(H, W, 3) tensor -> (labels, flags) of one hierarchy level:
    cfg.hierarchy_levels, or 4 (the reference benchmarks' level), capped
    at cfg.max_iters. Runs that level's rounds only."""
    h, w = image.shape[0], image.shape[1]
    lvl = min(cfg.hierarchy_levels if cfg.hierarchy_levels > 0 else 4,
              cfg.max_iters)
    if lvl == 0:
        return torch.arange(h * w, dtype=torch.int32,
                            device=image.device).reshape(h, w), 0
    L1, st, fins, rm, r0 = _run_rounds(image, cfg, lvl - 1)
    if lvl == 1:
        return L1, int(st.flags)
    labels, unconv = _render(L1, st.fin, rm, r0)
    return labels, int(turbo._raise_flag(st.flags, unconv,
                                         turbo.FLAG_GOSSIP_UNCONVERGED))


segment_superpixel_flagged = segment_superpixel_impl


def segment_superpixel(image: torch.Tensor,
                       cfg: SegmentationConfig) -> torch.Tensor:
    """One level of the superpixel hierarchy (cfg.hierarchy_levels, default
    4): the same labels as segment_superpixel_hierarchy(...)[0][level],
    without the other rounds or the level stack."""
    labels, flags = segment_superpixel_flagged(image, cfg)
    _check(flags, cfg)
    return labels

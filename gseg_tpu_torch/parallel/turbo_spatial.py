"""Row-sharded turbo path with explicit collectives (port of
`gseg_tpu/parallel/turbo_spatial.py`).

The image is split by rows over the ranks of a 1-D mesh (`parallel.mesh`),
and every cross-tile dependency of the turbo path is a collective:

  - prep (Gaussian + edge weights) takes a (radius + 1)-row halo once, and
    runs the dense path's own arithmetic on the slab (`ops.filters`,
    `ops.grid_graph`), so the weights are bit-equal to the dense path's;
  - stage G runs the gossip rounds with the subtree-sum sizes on every
    round (the reference's spatial schedule), its shifts taking one-row
    halos and its fixpoints the spatial route of `kernels.gossip`: on the
    card, passes of the step kernel over the tile padded with T = 8
    exchanged rows a side; on the CPU, the reference's one-row halo sweep;
    the changed flags and component counts are reduced over the ranks;
  - extraction dedups each tile's boundary pairs at a tile capacity, then
    gathers the small per-tile pools, sorts and dedups them globally: every
    rank ends with the same compact edge list;
  - stage 2 (the compact rounds) runs replicated: the same computation on
    every rank, no communication;
  - the final map seeds each tile from the replicated root map and value-
    floods it through the spatial route.

The partition equals the dense `segment_turbo`'s exactly, in speed and in
quality mode (the bucket thresholds come from the gathered weight planes
with the dense arithmetic; the ramp, the handoff gate and stage 2 are the
dense path's). The reference's `GSEG_FINAL_GATHER` knob is not ported.

Memory ceiling: the sharded stage-G planes shrink with the mesh, but from
the handoff on every rank holds V-sized int32 / float32 vectors (the
gathered label, size and Int planes, stage 2's V-slot tables, the root
table and the seed; in quality mode the gathered weight planes, 4 V, for
the thresholds): six to ten at a time, 24-40 bytes a pixel. The per-rank
peak falls with the mesh only down to that replicated term, so the
largest image a mesh can take is bounded by one device's memory, whatever
the number of ranks (PERF.md §6 has the measured peaks).
"""

from __future__ import annotations

import torch

from ..config import SegmentationConfig
from ..models import turbo
from ..ops import filters
from ..ops import grid_graph as gg
from .mesh import axis_devices, row_tiles, run_ranks

INT32_MAX = gg.INT32_MAX


def _make_comm(rank) -> turbo.Comm:
    """The turbo path's hooks on a row tile: shifts across rows take a
    one-row halo."""
    def shift(x, dy, dx, fill):
        if dy == 0:
            return gg.shift_plane(x, dy, dx, fill)
        return gg.shift_plane(rank.halo(x, 1, fill), dy, dx, fill)[1:-1]

    def shifts8(x, fill):
        xp = rank.halo(x, 1, fill)
        return [gg.shift_plane(xp, dy, dx, fill)[1:-1] for dy, dx in gg.DIRS8]

    return turbo.Comm(shift=shift, shifts8=shifts8, reduce_any=rank.any,
                      reduce_sum=rank.sum, rank=rank)


def halo_rows(sigma: float) -> int:
    """Rows of halo the smoothing and the edge weights need: the Gaussian
    radius, plus one for the edges to the next row."""
    return (len(filters.gaussian_kernel_1d(sigma)) - 1) // 2 + 1


def _prep_spatial(tile, cfg: SegmentationConfig, rank, row_off, h_glob):
    """The (4, h, w) canonical edge-weight planes of a row tile: the dense
    path's smoothing and weight arithmetic on the tile with a halo of
    `halo_rows` edge-replicated rows, then the global validity. The shift-
    sum smoothing of a row reads only rows within the radius, so the slab's
    rows [k - 1, h + k + 1) are exact, and each weight is the same float
    operations on the same values as on the whole plane."""
    k = halo_rows(cfg.sigma)
    sm = filters.gaussian_smooth(rank.halo(tile.to(torch.float32), k, None),
                                 cfg.sigma)
    sm = sm[k - 1:sm.shape[0] - (k - 1)]
    weights, _ = gg.edge_weight_planes(sm, cfg.connectivity,
                                       cfg.quantize_weight_bits)
    weights = weights[:, 1:-1]
    h, w = tile.shape[0], tile.shape[1]
    rowg = row_off + torch.arange(h, device=tile.device)[:, None]
    colg = torch.arange(w, device=tile.device)[None, :]
    valid = torch.stack([(rowg + dy < h_glob) & (colg + dx >= 0)
                         & (colg + dx < w) for dy, dx in gg.DIRS4])
    return torch.where(valid, weights, torch.inf).contiguous()


def _incident_views_spatial(weights, vidg, comm):
    """gg.incident_views with global vertex ids and halo shifts."""
    w8, eid8 = [], []
    for d in range(4):
        w8.append(weights[d])
        eid8.append(torch.where(torch.isfinite(weights[d]), vidg * 4 + d,
                                INT32_MAX))
    for d, (dy, dx) in enumerate(gg.DIRS4):
        wt = comm.shift(weights[d], -dy, -dx, torch.inf)
        anchor = comm.shift(vidg, -dy, -dx, 0)
        w8.append(wt)
        eid8.append(torch.where(torch.isfinite(wt), anchor * 4 + d,
                                INT32_MAX))
    return torch.stack(w8), torch.stack(eid8)


def _global_vid(rank, h, w, device):
    row_off = rank.index * h
    return row_off, ((row_off + torch.arange(h, dtype=torch.int32,
                                             device=device))[:, None] * w
                     + torch.arange(w, dtype=torch.int32, device=device))


def _rank_graph(rank, tile, cfg, h_glob):
    """A rank's tile -> (row offset, global vertex ids, weight planes,
    comm, w8, eid8)."""
    h, w = tile.shape[0], tile.shape[1]
    row_off, vidg = _global_vid(rank, h, w, tile.device)
    comm = _make_comm(rank)
    weights = _prep_spatial(tile, cfg, rank, row_off, h_glob)
    w8, eid8 = _incident_views_spatial(weights, vidg, comm)
    return row_off, vidg, weights, comm, w8, eid8


def _stage_g_spatial(w8, eid8, vidg, v, max_sweeps, cfg, gossip_rounds,
                     thresholds, comm):
    """The gossip rounds on a row tile (subsum sizes every round), with the
    dense path's handoff gate."""
    h, w = vidg.shape
    dev = vidg.device
    quality = cfg.weight_buckets > 0
    nb = max(cfg.weight_buckets, 1)
    gate_c = v // (turbo._GATE_DIV_Q if quality else turbo._GATE_DIV)
    gst = turbo.GossipState(
        L=vidg, S=torch.ones((h, w), dtype=torch.int32, device=dev),
        ID=torch.zeros((h, w), dtype=torch.float32, device=dev),
        merged=True, it=0, bucket=0,
        flags=torch.zeros((), dtype=torch.int32, device=dev))

    def gcond(s):
        return s.merged and (s.it < gossip_rounds
                             or comm.reduce_sum((s.L == vidg).sum()) > gate_c)

    while gcond(gst):
        s2 = turbo._ground(gst, w8, eid8, cfg.k, max_sweeps, sizes="subsum",
                           idle_compmin=gst.it == 0,
                           tau=thresholds[gst.bucket] if quality else None,
                           comm=comm, vid=vidg)
        # quality mode: the cap rises one bucket per round; the rounds go
        # on while buckets remain, even if this one merged nothing.
        gst = s2._replace(bucket=min(gst.bucket + 1, nb - 1),
                          merged=s2.merged or gst.bucket + 1 < nb)
    return gst


def _extract_spatial(comm, gst, weights, vidg, v, cfg):
    """Per-tile chunked pair dedup, then the pools gathered, sorted and
    deduped globally, and the stage-2 entry state built by the dense
    helper (replicated from here on). Returns (st, rm, r0, Lg)."""
    quality = cfg.weight_buckets > 0
    rank = comm.rank
    ew4 = torch.stack([weights[d] for d in range(4)], -1).reshape(-1)
    la = torch.stack([gst.L] * 4, -1).reshape(-1)
    lb = torch.stack([comm.shift(gst.L, dy, dx, -1) for dy, dx in gg.DIRS4],
                     -1).reshape(-1)
    eid4 = torch.stack([vidg * 4 + d for d in range(4)], -1).reshape(-1)
    live4 = torch.isfinite(ew4) & (la != lb) & (lb >= 0)
    lo = torch.where(live4, torch.minimum(la, lb), INT32_MAX)
    hi = torch.where(live4, torch.maximum(la, lb), INT32_MAX)
    # the dense pool divisors (following the gates), halved per tile for
    # cross-tile duplicate headroom.
    pair_div = (min(6, max(turbo._GATE_DIV_Q // 5, 2)) if quality
                else min(24, max(turbo._GATE_DIV // 4, 3)))
    cap_loc = max(vidg.numel() // max(pair_div // 2, 1), turbo._CAP_FLOOR)
    pm_l, plo_l, phi_l, pw_l, pe_l, ovf_l = turbo._chunked_pair_extract(
        lo, hi, ew4, eid4, cap_loc)
    plo_l = torch.where(pm_l, plo_l, INT32_MAX)
    phi_l = torch.where(pm_l, phi_l, INT32_MAX)
    pw_l = torch.where(pm_l, pw_l, torch.inf)
    g_lo, g_hi, g_w, g_e = (rank.all_gather_rows(x)
                            for x in (plo_l, phi_l, pw_l, pe_l))
    # global flat dedup: pair minima are exact within tiles, cross-tile
    # duplicates resolve here.
    pair_cap = max(v // pair_div, turbo._CAP_FLOOR)
    perm = turbo._lexsort(turbo._key64(g_lo, g_hi), turbo._key64(g_w, g_e))
    s_lo, s_hi, s_w, s_e = g_lo[perm], g_hi[perm], g_w[perm], g_e[perm]
    head = turbo._run_heads(s_lo) | turbo._run_heads(s_hi)
    head &= s_lo != INT32_MAX
    pm, (plo, phi, pw, pe), pair_ovf = turbo._select_compact(
        head, [s_lo, s_hi, s_w, s_e], pair_cap)

    SZf = rank.all_gather_rows(gst.S).reshape(-1)
    IDf = rank.all_gather_rows(gst.ID).reshape(-1)
    Lg = rank.all_gather_rows(gst.L)
    base_flags = turbo._raise_flag(gst.flags, ovf_l, turbo.FLAG_PAIR_OVERFLOW)
    # the dense handoff's gate-following root list (the reference builds
    # this state with the dense `_pools_to_state`)
    comp_cap = turbo.capacities(v, cfg.weight_buckets)["comp_cap"]
    st, rm, r0 = turbo._pools_to_state(pm, plo, phi, pw, pe, pair_ovf, v,
                                       comp_cap, SZf, IDf, gst.bucket,
                                       base_flags)
    return st, rm, r0, Lg


def _turbo_rank(rank, tile, cfg: SegmentationConfig, gossip_rounds: int,
                h_glob: int):
    """One rank's share of segment_turbo_spatial. Returns (its (h, w)
    label tile, flags ORed over the ranks)."""
    h, w = tile.shape[0], tile.shape[1]
    v = h_glob * w
    max_sweeps = 4 * (h_glob + w)
    row_off, vidg, weights, comm, w8, eid8 = _rank_graph(rank, tile, cfg,
                                                         h_glob)
    thresholds = None
    if cfg.weight_buckets > 0:
        # exact global thresholds: the dense sampling on the gathered planes
        wg = torch.stack([rank.all_gather_rows(weights[d]) for d in range(4)])
        thresholds = turbo.bucket_thresholds(wg, cfg.weight_buckets)
    gst = _stage_g_spatial(w8, eid8, vidg, v, max_sweeps, cfg, gossip_rounds,
                           thresholds, comm)
    st, rm, r0, Lg = _extract_spatial(comm, gst, weights, vidg, v, cfg)
    st = turbo._s2_stage(st, v, cfg, thresholds)
    # the final map: the replicated root table seeds the tile's root
    # pixels, then the spatial value flood; under turbo._FINAL_GATHER each
    # pixel gathers its root's entry (the tile's labels are global root
    # ids, so no halo is exchanged).
    vid_full = torch.arange(v, dtype=torch.int32,
                            device=tile.device).reshape(h_glob, w)
    seed = torch.where(Lg == vid_full, Lg, INT32_MAX).reshape(-1)
    seed = turbo._scatter(seed, r0, st.fin)  # r0 holds v (dropped) where ~rm
    if turbo._FINAL_GATHER:
        labels, fm_unconv = turbo._root_gather(seed, gst.L), False
    else:
        seed = seed.reshape(h_glob, w)[row_off:row_off + h].contiguous()
        labels, fm_unconv = turbo._value_flood(gst.L, seed, max_sweeps,
                                               comm=comm)
    flags = turbo._raise_flag(st.flags, fm_unconv,
                              turbo.FLAG_GOSSIP_UNCONVERGED)
    return labels, rank.or_flags(flags)


def segment_turbo_spatial(image, cfg: SegmentationConfig, mesh,
                          axis: str = "space", gossip_rounds: int = 4):
    """Segment one (H, W, 3) image row-sharded over `mesh` (a
    `parallel.mesh.Mesh` whose axis `axis` holds the ranks) with explicit
    collectives. Returns ((H, W) int32 labels on the mesh's first device,
    int flags ORed over the ranks: nonzero means a capacity or sweep-budget
    violation, as for `segment_turbo_flagged`).

    H must be divisible by the axis size, and a tile must be at least as
    tall as the smoothing's halo. The partition equals the dense
    `segment_turbo`'s exactly (module note)."""
    devices = axis_devices(mesh, axis)
    tiles = row_tiles(image, devices)
    h, k = tiles[0].shape[0], halo_rows(cfg.sigma)
    if h < k:
        raise ValueError(
            f"tile height {h} < halo {k} (sigma={cfg.sigma}): the "
            "reference's halo exchange only reaches immediate neighbours")
    out = run_ranks(
        devices, lambda rank, tile: _turbo_rank(rank, tile, cfg,
                                                gossip_rounds,
                                                h * len(devices)), tiles)
    labels = torch.cat([lab.to(devices[0]) for lab, _ in out])
    return labels, out[0][1]

"""Turbo path (port of `gseg_tpu/models/turbo.py`).

Same partition and the same canonical min-vertex-id labels as the
reference's speed mode (`weight_buckets=0`) in its default configuration
(`GSEG_PEEL_SIZES` unset, i.e. "subsum" peel rounds), and as its quality
mode (`weight_buckets > 0`, scan closures on):

  STAGE G — gossip rounds over the pixel grid: component min edge by a
  lexmin fixpoint (`kernels.gossip.compmin_gossip`), merged labels by a
  min-label flood over same-label + passing-hook adjacency with Int(C)
  riding as a max. In the two peel rounds the BFS distance from the new
  root rides the flood too (`label_gossip`), and exact sizes come from a
  convergecast over the parent tree it defines (`subtree_sums`); later
  rounds run the dist-free flood (`label_flood`) and size components by
  grouping the compact old-root list. Rounds run until at most V/128
  components remain. `_PEEL_SIZES = "count"` selects the reference's
  `GSEG_PEEL_SIZES=count` peel instead (dist-free flood, counting
  scatter), and `"runs"` its `GSEG_PEEL_SIZES=runs` peel (dist-free flood,
  sizes from the row-run pool of `kernels.runs.run_extract`); both give
  the same labels.

  QUALITY MODE — the weight-quantile bucket ramp (`bucket_thresholds`):
  round r only sees edges at most the r-th of `weight_buckets` quantiles
  (felz rounds in stage 2 too), the cap rising one bucket per round, and
  min-size rounds start only once every bucket is open. Stage G runs two
  count-peel rounds, a full-V root list, then root-list rounds down to V/32
  components; every fixpoint takes the hybrid route with scan closures
  (`closures=True`). The handoff and stage 2 use the reference's quality
  capacities.

  HANDOFF — live boundary edges are extracted into a compact pool
  (`kernels.extract.boundary_extract`) and deduplicated to the min edge per
  component pair.

  STAGE 2 — compact Boruvka rounds on the edge pool (sorts, compaction,
  pointer doubling), then the min-size rounds.

  FINAL — each component's final root is placed on its root pixel and
  value-flooded over the stage-G components (`value_flood`).

  HIERARCHY — `segment_turbo_hierarchy` records one label map per felz
  round: stage-G rounds (count-peel sizes) capture their label plane,
  stage-2 rounds their compact root map, rendered as the final map is (one
  value flood per distinct map). Levels stay on the device. Its overflow
  fallback is the fastmst hierarchy; `segment_turbo`'s the atomic path.

  ALTERNATIVES — the reference's exact alternative routes, selected by
  module attributes in place of its environment variables (defaults as
  in the reference): `_FINAL_GATHER` (GSEG_FINAL_GATHER=1: each final map
  and hierarchy level is one gather of the root table, no value flood),
  `_FLOOD_PTR` (GSEG_FLOOD_PTR=1: the root-list rounds resolve labels by
  pointer doubling on the root list, `_flood_pointer`), `_RLIST_SPLIT` and
  `_RLIST_TIERS_Q` (GSEG_RLIST_SPLIT, GSEG_RLIST_TIERS_Q), `_LATE_CLOSURES`
  and `_Q_CLOSURES` (GSEG_LATE_CLOSURES, GSEG_Q_CLOSURES), `_RUNS_DIV`
  (GSEG_RUNS_DIV) and `_S2_SMALL_DIV` / `_S2_SMALL_DIV_Q`
  (GSEG_S2_SMALL_DIV). Each gives the same labels and flags.

Every `lax.while_loop` of the reference is a host loop that reads a device
value each iteration, and every `lax.cond` a host `if`. Capacities are the
reference's, following its handoff gates (`_GATE_DIV`, V/128 by default;
`_GATE_DIV_Q`, V/32); overflows raise FLAG_* bits and are never silent.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SegmentationConfig
from ..ops import filters
from ..ops import grid_graph as gg
from ..ops.kernels import extract as kx
from ..ops.kernels import gossip as kg
from ..ops.kernels import runs as kr

INT32_MAX = gg.INT32_MAX
BIGDIST = kg.BIGDIST

FLAG_GOSSIP_UNCONVERGED = 1   # a sweep fixpoint hit its sweep cap
FLAG_PAIR_OVERFLOW = 2        # extracted pair count exceeded pair_cap
FLAG_COMP_OVERFLOW = 4        # live component heads exceeded comp_cap
FLAG_RECOMPACT_OVERFLOW = 8   # deduped pairs exceeded the recompact cap
FLAG_ITERS_EXHAUSTED = 16     # stage-2 exited its round budget unconverged

_RLIST_FLOOR = 16384  # min sliced root-list capacity (tests shrink it)
_CAP_FLOOR = 16384    # min pool/recompact capacity (tests shrink it)
_EX_SMALL = True      # handoff: dedup only the live head of the pool
_PEEL_SIZES = "subsum"  # peel-round sizes: "subsum" (default), "count", "runs"
_GATE_DIV = 128       # speed-mode handoff: at most V/128 components
_GATE_DIV_Q = 32      # quality-mode handoff: at most V/32 components
_S2_SMALL = True      # stage 2: run the early rounds on a sliced pool
_S2_SMALL_DIV = 64    # ... of V/64 pairs a half (speed mode)
_S2_SMALL_DIV_Q = 24  # ... of V/24 pairs a half (quality mode)
_RUNS_DIV = 2         # the runs peel's pool holds V/_RUNS_DIV runs
PAIR_CHUNK = 131072   # slots a chunk of _chunked_pair_extract sorts
# The reference's exact alternative routes (its GSEG_* switches), each
# giving the same labels and flags; the defaults are the reference's.
_FINAL_GATHER = False   # final maps: one V-sized gather of the root table
#                         (GSEG_FINAL_GATHER=1) in place of the value flood
_FLOOD_PTR = False      # root-list rounds: pointer doubling on the root
#                         list (GSEG_FLOOD_PTR=1) in place of the label flood
_RLIST_SPLIT = True     # root-list rounds: slice the list as roots thin out
#                         (False: one loop at full capacity)
_RLIST_TIERS_Q = (16,)  # quality mode: the slices, V / each (a tier ladder)
_LATE_CLOSURES = False  # speed mode: root-list rounds on the closure route
_Q_CLOSURES = True      # quality mode: fixpoints on the closure route


class GossipState(NamedTuple):
    L: torch.Tensor       # (H, W) int32 canonical labels (min vertex id)
    S: torch.Tensor       # (H, W) int32 component size at the root pixel
    # (only root pixels are read: after a subsum round the other pixels
    # hold their subtree sizes, whose max per component is the root's.)
    ID: torch.Tensor      # (H, W) float32 Int(C), replicated
    merged: bool
    it: int
    bucket: int           # weight-bucket index (quality mode; 0 in speed)
    flags: torch.Tensor   # () int32 FLAG_* bits accumulated so far


class CompactState(NamedTuple):
    esrc: torch.Tensor    # (E,) int32 current comp label of endpoint a
    edst: torch.Tensor    # (E,) int32
    ew: torch.Tensor      # (E,) float32 (+inf dead)
    eeid: torch.Tensor    # (E,) int32 canonical edge id (global tie-break)
    SZf: torch.Tensor     # (V,) int32 sizes at root slots
    IDf: torch.Tensor     # (V,) float32 Int at root slots
    fin: torch.Tensor     # (C,) int32 current root of each initial root
    merged: bool
    it: int
    bucket: int           # weight-bucket index, carried from stage G
    phase: int            # 0 = felz rounds, 1 = min-size rounds
    flags: torch.Tensor   # () int32 FLAG_* bits accumulated so far


# ---------------------------------------------------------------------------
# helpers for the reference's sort/scatter idioms
# ---------------------------------------------------------------------------


def _raise_flag(flags, cond, bit):
    """flags | bit where cond (a Python bool or a 0-d device bool)."""
    if isinstance(cond, bool):
        return flags | bit if cond else flags
    return flags | cond.to(torch.int32) * bit


def _key64(a, b):
    """int64 sort key ordering like the pair (a, b), for non-negative int32
    or float32 a, b (non-negative floats order like their bits)."""
    def bits(x):
        return (x.view(torch.int32) if x.dtype == torch.float32
                else x).to(torch.int64)
    return (bits(a) << 32) | bits(b)


def _lexsort(*keys):
    """Permutation sorting by keys[0], then keys[1], ...: stable sorts
    chained from the last key to the first (`lax.sort(num_keys=k)`)."""
    perm = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _gather(x, idx):
    """x[idx] with out-of-range indices clamped, as XLA gathers clamp (only
    masked-out lanes ever carry such indices)."""
    return x[idx.to(torch.int64).clamp(0, x.numel() - 1)]


def _scatter(base, idx, vals, reduce=None):
    """base.at[idx].<reduce>(vals, mode="drop") with idx == len(base) as the
    dropped slot. reduce: None (set), "sum", "amin" or "amax"."""
    ext = torch.cat([base, base.new_zeros(1)])
    idx = idx.to(torch.int64)
    if reduce is None:
        ext.scatter_(0, idx, vals)
    else:
        ext.scatter_reduce_(0, idx, vals, reduce)
    return ext[:-1]


def _run_heads(x):
    head = torch.ones_like(x, dtype=torch.bool)
    head[1:] = x[1:] != x[:-1]
    return head


def _shifts8(x, fill):
    return [gg.shift_plane(x, dy, dx, fill) for dy, dx in gg.DIRS8]


class Comm(NamedTuple):
    """Communication hooks of stage G and the final map (the reference's
    `Comm`). The dense default runs on one device: plain shifts, host reads
    of local values, the fixpoint wrappers. `parallel.turbo_spatial`
    substitutes halo-exchange shifts and reductions over the ranks of a
    row-sharded mesh, and `rank`, whose collectives the spatial fixpoints
    use (`kernels.gossip.*_spatial`)."""
    shift: object       # (x, dy, dx, fill) -> plane
    shifts8: object     # (x, fill) -> 8 planes (DIRS8 order)
    reduce_any: object  # local bool or 0-d tensor -> global bool
    reduce_sum: object  # local int or 0-d tensor -> global int
    rank: object        # parallel.mesh.Rank, or None (dense)

    @property
    def dense(self) -> bool:
        return self.rank is None


DENSE = Comm(shift=gg.shift_plane, shifts8=_shifts8, reduce_any=bool,
             reduce_sum=int, rank=None)


# ---------------------------------------------------------------------------
# Stage G: gossip rounds
# ---------------------------------------------------------------------------


def bucket_thresholds(weights, num_buckets: int) -> torch.Tensor:
    """Quality-mode weight caps: the quantiles of a strided sample of the
    finite edge weights, the last bucket +inf (the reference's
    `bucket_thresholds` and `boruvka_cpu.bucket_thresholds_np`: same
    sample, same int32 index arithmetic)."""
    flat = torch.stack([weights[d] for d in range(4)], -1).reshape(-1)
    stride = max(flat.numel() // 65536, 1)
    sample = flat[::stride][:65536]
    sample = torch.where(torch.isfinite(sample), sample, torch.inf)
    sample = torch.sort(sample).values
    n = sample.numel()
    n_fin = torch.isfinite(sample).sum().to(torch.int32)
    bs = torch.arange(num_buckets, dtype=torch.int32, device=weights.device)
    idx = torch.div((bs + 1) * n_fin, num_buckets, rounding_mode="floor") - 1
    idx = torch.minimum(idx.clamp(min=0), (n_fin - 1).clamp(min=0))
    out = sample[idx.clamp(0, n - 1).to(torch.int64)]
    out[num_buckets - 1] = torch.inf
    return out


def _vertex_min_outgoing(L, w8, eid8, tau=None, comm=DENSE):
    """Per pixel, its min outgoing edge (w, eid) to another label, among
    edges at most tau (None: all)."""
    nbrL = torch.stack(comm.shifts8(L, -1))
    outgoing = nbrL != L[None]
    if tau is not None:
        outgoing &= w8 <= tau
    w = torch.where(outgoing, w8, torch.inf)
    vminw = w.amin(0)
    veid = torch.where(w == vminw[None], eid8, INT32_MAX).amin(0)
    veid = torch.where(torch.isfinite(vminw), veid, INT32_MAX)
    return vminw, veid, nbrL


def _build_rlist(L, cap: int):
    """Sorted list of root-pixel flat ids (INT32_MAX dead slots), overflow."""
    v = L.numel()
    flat = torch.arange(v, dtype=torch.int32, device=L.device)
    key = torch.where(L.reshape(-1) == flat, flat, INT32_MAX)
    srt = torch.sort(key).values
    if cap >= v:
        pad = torch.full((cap - v,), INT32_MAX, dtype=torch.int32,
                         device=L.device)
        return torch.cat([srt, pad]), False
    return srt[:cap], srt[cap] != INT32_MAX


def _sum_by_label(lab, val, h, w):
    """Sum `val` grouped by `lab` (root-pixel flat ids; INT32_MAX = dead) ->
    ((H, W) plane with each group's total at its root pixel / 0 elsewhere,
    sorted label list with INT32_MAX at non-head slots)."""
    v = h * w
    s_lab, order = torch.sort(lab, stable=True)
    head = _run_heads(s_lab)
    gid = torch.cumsum(head, 0) - 1
    total = torch.zeros_like(val).index_add_(0, gid, val[order])
    live_head = head & (s_lab != INT32_MAX)
    S = _scatter(torch.zeros(v, dtype=torch.int32, device=lab.device),
                 torch.where(live_head, s_lab, v), total[gid])
    roots = torch.where(live_head, s_lab, INT32_MAX)
    return S.reshape(h, w), roots


def _rlist_sizes(rlist, Lnew, S_old):
    """Exact new-component sizes from the old-root list: each new component
    is a disjoint union of old ones, so its size is the old roots' S summed
    by their new label. Returns (S plane, new rlist)."""
    h, w = Lnew.shape
    alive = rlist != INT32_MAX
    safe = torch.where(alive, rlist, 0).to(torch.int64)
    Lr = torch.where(alive, Lnew.reshape(-1)[safe], INT32_MAX)
    Sr = torch.where(alive, S_old.reshape(-1)[safe], 0)
    return _sum_by_label(Lr, Sr, h, w)


def _component_sizes(L):
    """Exact per-component pixel counts (peel rounds): one counting scatter
    keyed by label. Returns ((H, W) size at root pixel / 0 elsewhere,
    overflow=False)."""
    h, w = L.shape
    v = h * w
    S = torch.bincount(L.reshape(-1).to(torch.int64), minlength=v)
    S = S.to(torch.int32).reshape(h, w)
    vid = torch.arange(v, dtype=torch.int32, device=L.device).reshape(h, w)
    return torch.where(L == vid, S, 0), False


def _runs_sizes(L):
    """Exact per-component pixel counts from the row-run pool: the row runs
    of L partition the plane, so run lengths summed by label count each
    component (one cap-sized sort). When the pool overflows, the counting
    scatter gives the same sizes. Returns ((H, W) size at root pixel / 0
    elsewhere, overflow=False)."""
    h, w = L.shape
    lab, cnt, _, ovf = kr.run_extract(L, max(h * w // _RUNS_DIV, 1024))
    if bool(ovf):
        return _component_sizes(L)
    return _sum_by_label(lab, cnt, h, w)[0], False


def _parent_dirs(L, dist, comm=DENSE):
    """Each pixel's parent in the BFS tree: the first DIRS8 direction whose
    same-label neighbour is one level closer (8 = root / unreached)."""
    nL = comm.shifts8(L, -1)
    nd = comm.shifts8(dist, BIGDIST)
    pdir = torch.full_like(L, 8)
    for d in range(7, -1, -1):
        ok = (nL[d] == L) & (nd[d] == dist - 1) & (dist > 0) \
            & (dist < BIGDIST)
        pdir = pdir.masked_fill(ok, d)
    return pdir


def _subtree_sizes(L, dist, max_sweeps, comm=DENSE):
    """Exact component size at the canonical root pixel, from the converged
    BFS levels: subtree sums over the parent tree give |C| at the root.
    Returns (sizes, unconverged)."""
    pdir = _parent_dirs(L, dist, comm)
    if comm.dense:
        return kg.subtree_sums(pdir, torch.ones_like(L), max_sweeps)
    return kg.subtree_sums_spatial(pdir, torch.ones_like(L), max_sweeps,
                                   comm.rank)


def _flood_pointer(L, id_init, pass8, nbrL, rlist):
    """The dist-free label flood of a root-list round, resolved on the root
    list (the reference's `_flood_pointer`, GSEG_FLOOD_PTR=1): the flood's
    cross-label edges are each component's own passed min edge, a
    functional hook graph on the roots whose cycles have length 2. So: one
    scatter-min of each component's hook partner to its root slot, the
    2-cycles broken to their min endpoint, pointer doubling over the list
    (at most 24 steps), the min old root of each hook tree as the new
    label, and one gather per pixel for the label and for the max-ride of
    id_init. Returns (Lnew, IDnew, unconverged): the flood's fixpoint, and
    True only if 24 doubling steps did not converge."""
    h, w = L.shape
    v = h * w
    dev = L.device
    cap = rlist.numel()
    Lf = L.reshape(-1)
    # 1. each component's hook partner at its root slot.
    partner = torch.full((h, w), INT32_MAX, dtype=torch.int32, device=dev)
    for d in range(8):
        partner = torch.where(pass8[d], torch.minimum(partner, nbrL[d]),
                              partner)
    S0 = _scatter(torch.full((v,), INT32_MAX, dtype=torch.int32, device=dev),
                  Lf, partner.reshape(-1), "amin")
    # 2. the list's view: slot -> root id (0 where dead), root id -> slot.
    alive = rlist != INT32_MAX
    self_id = torch.where(alive, rlist, 0)
    inv = _scatter(torch.zeros(v, dtype=torch.int32, device=dev),
                   torch.where(alive, rlist, v),
                   torch.arange(cap, dtype=torch.int32, device=dev))
    sp = S0[self_id.to(torch.int64)]
    sp = torch.where(alive & (sp != INT32_MAX), sp, self_id)
    # mutual hooks keep the min endpoint as their root.
    s2 = sp[inv[sp.to(torch.int64)].to(torch.int64)]
    par = torch.where(s2 == self_id, torch.minimum(self_id, sp), sp)
    changed, i = True, 0
    while changed and i < 24:
        pn = par[inv[par.to(torch.int64)].to(torch.int64)]
        changed = bool((pn != par).any())
        par, i = pn, i + 1
    # 3. the min old root of each hook tree, per slot, then per root id.
    minid = _scatter(torch.full((v,), INT32_MAX, dtype=torch.int32,
                                device=dev),
                     torch.where(alive, par, v), self_id, "amin")
    nl = minid[par.to(torch.int64)]
    newlab = _scatter(torch.zeros(v, dtype=torch.int32, device=dev),
                      torch.where(alive, rlist, v), nl)
    # 4. each pixel's new label, and Int riding as a max.
    Lnew = newlab[Lf.to(torch.int64)]
    idtab = _scatter(torch.zeros(v, dtype=torch.float32, device=dev), Lf,
                     id_init.reshape(-1), "amax")
    idt2 = _scatter(torch.zeros(v, dtype=torch.float32, device=dev),
                    torch.where(alive, nl, v),
                    idtab[self_id.to(torch.int64)], "amax")
    IDnew = idt2[Lnew.to(torch.int64)]
    return Lnew.reshape(h, w), IDnew.reshape(h, w), changed


def _ground(state: GossipState, w8, eid8, k, max_sweeps, rlist=None,
            sizes="subsum", idle_compmin=False, tau=None, closures=False,
            comm=DENSE, vid=None):
    """One gossip Boruvka round (felz predicate).

    sizes="subsum": the label flood carries the BFS dist from the new
    roots, and subtree sums over its parent tree give exact sizes (the
    reference's default peel rounds).
    sizes="count": dist-free flood, exact sizes by a counting scatter.
    sizes="runs": dist-free flood, exact sizes from the row-run pool.
    sizes="rlist": dist-free flood, sizes by grouping the compact old-root
    list `rlist`; returns (state, new rlist). Under `_FLOOD_PTR` (dense
    only) `_flood_pointer` replaces this round's flood.
    idle_compmin: True on round 1 (all-singleton labels: the compmin
    fixpoint is the identity). tau: the round's weight cap (quality mode;
    None: no cap). closures: the fixpoints' hybrid route (quality mode).
    comm: a row tile's halo shifts and reductions (`parallel.turbo_spatial`;
    sizes "subsum" only, no closures), with vid the tile's global vertex
    ids (None: the dense plane's)."""
    L, S, ID = state.L, state.S, state.ID
    if not comm.dense and (sizes != "subsum" or closures):
        raise ValueError("a spatial round takes sizes='subsum' and no "
                         "closures")

    vminw, veid, nbrL = _vertex_min_outgoing(L, w8, eid8, tau, comm)
    if comm.dense:
        cw, ce, SZ, unconv = kg.compmin_gossip(L, vminw, veid, S, max_sweeps,
                                               idle=idle_compmin,
                                               closures=closures)
    else:
        cw, ce, SZ, unconv = kg.compmin_gossip_spatial(
            L, vminw, veid, S, max_sweeps, comm.rank, idle=idle_compmin)

    # Multiply-form predicate (w - Int) * |C| <= k, as separate float32 ops.
    kf = torch.tensor(k, dtype=torch.float32, device=L.device)
    SZf = SZ.to(torch.float32)
    my_ok = (cw - ID) * SZf <= kf
    ID8 = torch.stack(comm.shifts8(ID, 0.0))
    SZ8 = torch.stack(comm.shifts8(SZf, 0.0))
    owner8 = (nbrL != L[None]) & (w8 == cw[None]) & (eid8 == ce[None])
    pass8 = owner8 & my_ok[None] & ((cw[None] - ID8) * SZ8 <= kf)

    new_mark4 = [pass8[dc] | comm.shift(pass8[dc + 4], dy, dx, False)
                 for dc, (dy, dx) in enumerate(gg.DIRS4)]
    merged = comm.reduce_any(torch.stack(new_mark4).any())

    allow = []
    for d in range(8):
        if d < 4:
            am = new_mark4[d]
        else:
            dy, dx = gg.DIRS4[d - 4]
            am = comm.shift(new_mark4[d - 4], -dy, -dx, False)
        allow.append((nbrL[d] == L) | am)
    allow8 = torch.stack(allow)

    hook8 = allow8 & (nbrL != L[None])
    used_w8 = torch.where(hook8, torch.where(torch.isfinite(w8), w8, 0.0), 0.0)
    id_init = torch.maximum(ID, used_w8.amax(0))

    bits = kg.pack_allow_bits(allow)
    size_unconv = False
    if sizes == "subsum":
        # dist seeded 0 at the old roots: the new cluster root (an old root
        # that keeps its label) keeps 0, absorbed roots take over on
        # adoption.
        if vid is None:
            vid = torch.arange(L.numel(), dtype=torch.int32,
                               device=L.device).reshape(L.shape)
        dist0 = torch.full_like(L, BIGDIST).masked_fill(L == vid, 0)
        if comm.dense:
            Lnew, IDnew, dist, lab_unconv = kg.label_gossip(
                bits, L, id_init, dist0, max_sweeps)
        else:
            Lnew, IDnew, dist, lab_unconv = kg.label_gossip_spatial(
                bits, L, id_init, dist0, max_sweeps, comm.rank)
        Snew, size_unconv = _subtree_sizes(Lnew, dist, max_sweeps, comm)
    elif sizes == "rlist" and comm.dense and _FLOOD_PTR:
        Lnew, IDnew, lab_unconv = _flood_pointer(L, id_init, pass8, nbrL,
                                                 rlist)
    else:
        # Away from hook pixels Lc (= L) and Int are uniform per old
        # component, so hook-free tiles start at a local fixpoint: the
        # first pass runs near the hooks only.
        Lnew, IDnew, lab_unconv = kg.label_flood(bits, L, id_init,
                                                 max_sweeps,
                                                 closures=closures,
                                                 seed_mask=hook8.any(0))
    if sizes == "rlist":
        Snew, rlist_new = _rlist_sizes(rlist, Lnew, S)
    elif sizes == "count":
        Snew, _ = _component_sizes(Lnew)
    elif sizes == "runs":
        Snew, _ = _runs_sizes(Lnew)
    flags = _raise_flag(state.flags, unconv or lab_unconv or size_unconv,
                        FLAG_GOSSIP_UNCONVERGED)
    out = GossipState(L=Lnew, S=Snew, ID=IDnew, merged=merged,
                      it=state.it + 1, bucket=state.bucket, flags=flags)
    return (out, rlist_new) if sizes == "rlist" else out


def _rlist_loop(gcond, gbody, gst, rlist, vid, caps):
    """Root-list rounds: at full list capacity while more roots live than
    the first of `caps`, then on the list sorted and sliced to it, and so
    on down the list. Slicing is lossless once every live root fits, and
    the component count only decreases, so this runs exactly the rounds a
    single loop would, which is what `_RLIST_SPLIT = False` runs."""
    for cap in [c for c in caps if c < rlist.numel() and _RLIST_SPLIT]:
        while gcond(gst) and int((gst.L == vid).sum()) > cap:
            gst, rlist = gbody(gst, rlist)
        # dead slots sit interleaved in the list: sort them to the tail.
        rlist = torch.sort(rlist).values[:cap]
    while gcond(gst):
        gst, rlist = gbody(gst, rlist)
    return gst


def _stage_g(image, cfg: SegmentationConfig, gossip_rounds: int,
             weights_override=None, capture=None):
    """Smoothing + implicit graph + gossip rounds; returns (state, weights,
    thresholds): the bucket caps in quality mode, else None.

    weights_override: optional (4, H, W) float32 planes that replace the
    smoothing + edge-weight computation (parity-testing hook: feeding both
    packages the same weights isolates the partition logic from float drift
    in the filter chain).
    capture: the hierarchy's stage G (the reference's `_stage_g_capture`):
    called as capture(round index, labels) after every round; the peel
    rounds then size by the counting scatter, and the root list gets the
    hierarchy's capacity."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    dev = image.device
    max_sweeps = 4 * (h + w)

    if weights_override is not None:
        if not isinstance(weights_override, torch.Tensor):
            weights_override = torch.tensor(np.asarray(weights_override))
        weights = weights_override.to(dev, torch.float32).contiguous()
    else:
        smoothed = filters.gaussian_smooth(image, cfg.sigma)
        weights, _ = gg.edge_weight_planes(smoothed, cfg.connectivity,
                                           cfg.quantize_weight_bits)
    w8, eid8 = gg.incident_views(weights)
    vid = torch.arange(v, dtype=torch.int32, device=dev).reshape(h, w)

    quality = cfg.weight_buckets > 0
    closures = quality and _Q_CLOSURES
    nb = max(cfg.weight_buckets, 1)
    thresholds = bucket_thresholds(weights, nb) if quality else None

    def tau(s):
        return thresholds[s.bucket] if quality else None

    def advance(s, s2):
        # quality mode: the cap rises one bucket per round; the rounds go
        # on while buckets remain, even if this one merged nothing.
        return s2._replace(bucket=min(s.bucket + 1, nb - 1),
                           merged=s2.merged or s.bucket + 1 < nb)

    gst = GossipState(
        L=vid, S=torch.ones((h, w), dtype=torch.int32, device=dev),
        ID=torch.zeros((h, w), dtype=torch.float32, device=dev),
        merged=True, it=0, bucket=0,
        flags=torch.zeros((), dtype=torch.int32, device=dev))

    def captured(it, s):
        if capture is not None:
            capture(it, s.L)
        return s

    # two peel rounds (quality mode: count sizes, closures on unless
    # _Q_CLOSURES is False).
    while gst.merged and gst.it < 2:
        gst = captured(gst.it, advance(gst, _ground(
            gst, w8, eid8, cfg.k, max_sweeps,
            sizes="count" if quality or capture is not None else _PEEL_SIZES,
            idle_compmin=gst.it == 0, tau=tau(gst), closures=closures)))
    # quality mode: the bucket ramp merges slowly, so the root list gets
    # full pixel capacity (the hierarchy's: up to 2^20 pixels too).
    caps = capacities(v, cfg.weight_buckets)
    if capture is not None:
        rcap = v if quality or v <= 1 << 20 else max(v // 2, _CAP_FLOOR)
    else:
        rcap = caps["rcap"]
    rlist, rovf = _build_rlist(gst.L, rcap)
    gst = gst._replace(flags=_raise_flag(gst.flags, rovf, FLAG_COMP_OVERFLOW))

    gate_c = v // (_GATE_DIV_Q if quality else _GATE_DIV)

    def gcond(s):
        return s.merged and (s.it < gossip_rounds
                             or int((s.L == vid).sum()) > gate_c)

    def gbody(s, rl):
        s2, rl2 = _ground(s, w8, eid8, cfg.k, max_sweeps, rlist=rl,
                          sizes="rlist", tau=tau(s),
                          closures=closures if quality else _LATE_CLOSURES)
        return captured(s.it, advance(s, s2)), rl2

    gst = _rlist_loop(gcond, gbody, gst, rlist, vid, caps["rlist_caps"])
    return gst, weights, thresholds


# ---------------------------------------------------------------------------
# Handoff and stage 2: compact rounds
# ---------------------------------------------------------------------------


def capacities(v: int, weight_buckets: int) -> dict:
    """The fixed capacities of a turbo run at V pixels (the hierarchy's
    root list aside): the root list after the peel rounds (rcap) and its
    slices (rlist_caps), the handoff's candidate pool (cap_live) and pair
    pool (pair_cap), and the compact root list (comp_cap). The last three
    follow the handoff gate (`_GATE_DIV`, `_GATE_DIV_Q`, read at call
    time), as the reference's do: an earlier gate hands off more
    components over denser boundaries. At the default gates they are
    V/2, V/24 (quality V/6) and V/96 (quality V/24)."""
    quality = weight_buckets > 0
    gd, gdq = _GATE_DIV, _GATE_DIV_Q
    return {
        "rcap": v if quality else max(v // 4, _CAP_FLOOR),
        "rlist_caps": [max(v // d, _RLIST_FLOOR)
                       for d in (_RLIST_TIERS_Q if quality else (32,))],
        # an early speed gate's run candidates can pass V/2
        "cap_live": max(v if not quality and gd < 64 else v // 2, 1 << 16),
        "pair_cap": max(v // min(6, max(gdq // 5, 2)) if quality
                        else v // min(24, max(gd // 4, 3)), _CAP_FLOOR),
        "comp_cap": max(v // min(24, max(gdq * 3 // 4, 2)) if quality
                        else v // min(96, max(gd * 3 // 4, 2)), _CAP_FLOOR),
    }


def _s2_capacities(v: int, quality: bool) -> dict:
    """Stage 2's gate-following sizes (the reference's `_s2_stage`): the
    first recompact's cap (rec1_cap), speed mode's second (rec2_cap) and
    main-phase root list (comp_cap2), and the divisor of the live-count
    slice (small_div). At the default gates: V/64 (quality V/8), V/128,
    V/1024 and `_S2_SMALL_DIV(_Q)`."""
    gd, gdq = _GATE_DIV, _GATE_DIV_Q
    div = _S2_SMALL_DIV_Q if quality else _S2_SMALL_DIV
    if not quality and gd < 64:
        div = min(div, max(gd // 2, 4))   # earlier gates: denser live sets
    if quality and gdq < 24:
        div = min(div, max(gdq // 2, 2))
    return {
        "rec1_cap": max(v // min(8, max(gdq // 4, 2)) if quality
                        else v // min(64, max(gd // 2, 4)), _CAP_FLOOR),
        "rec2_cap": max(v // min(128, gd), _CAP_FLOOR // 2),
        "comp_cap2": max(v // min(1024, gd * 8), 4096),
        "small_div": div,
    }


def pair_chunks(n: int, chunk: int = PAIR_CHUNK) -> int:
    """The chunks `_chunked_pair_extract` sorts n slots in."""
    return -(-n // chunk)



def _select_compact(mask, keys, cap):
    """Move masked entries to the front (stable) and slice to `cap`.
    Returns (out_mask (cap,), [outs], overflow)."""
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    outs = [x[order][:cap] for x in keys]
    return mask[order][:cap], outs, mask.sum() > cap


def _pair_dedup(esrc, edst, ew, eid, cap):
    """Keep only the min (w, eid) edge per directed (src, dst) pair; arrays
    of size cap."""
    live = (esrc != edst) & torch.isfinite(ew)
    k1 = torch.where(live, esrc, INT32_MAX)
    k2 = torch.where(live, edst, INT32_MAX)
    perm = _lexsort(_key64(k1, k2), _key64(ew, eid))
    s1, s2, sw, se = k1[perm], k2[perm], ew[perm], eid[perm]
    head = torch.ones_like(live)
    head[1:] = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
    head &= s1 != INT32_MAX
    m, (o1, o2, ow, oe), ovf = _select_compact(head, [s1, s2, sw, se], cap)
    o1 = torch.where(m, o1, 0)
    o2 = torch.where(m, o2, 0)
    ow = torch.where(m, ow, torch.inf)
    return o1, o2, ow, oe, ovf


def _extract_stage(gst: GossipState, weights, cfg: SegmentationConfig):
    """Gossip -> compact handoff: the boundary_extract pool, then a flat
    sort-dedup of its live head. Returns (st, rm, r0)."""
    h, w = gst.L.shape
    v = h * w
    caps = capacities(v, cfg.weight_buckets)
    pair_cap, cap_live = caps["pair_cap"], caps["cap_live"]
    lo, hi, ew4, eid4, cnt, extract_ovf = kx.boundary_extract(
        gst.L, weights, cap_live)

    # live-count small path: entries sit in slots [0, cnt), so when they
    # fit a quarter of the pool only that slice is sorted. The count is
    # exact here, so this branch may differ from the reference's (whose
    # count is an upper bound); results do not.
    small_cap = max(cap_live // 4, pair_cap)
    n = cap_live
    if _EX_SMALL and small_cap < cap_live and int(cnt) <= small_cap:
        n = small_cap
    lo, hi, ew4, eid4 = lo[:n], hi[:n], ew4[:n], eid4[:n]
    perm = _lexsort(_key64(lo, hi), _key64(ew4, eid4))
    s_lo, s_hi, s_w, s_e = lo[perm], hi[perm], ew4[perm], eid4[perm]
    head = torch.ones_like(s_lo, dtype=torch.bool)
    head[1:] = (s_lo[1:] != s_lo[:-1]) | (s_hi[1:] != s_hi[:-1])
    head &= s_lo != INT32_MAX
    pm, (plo, phi, pw, pe), pair_ovf = _select_compact(
        head, [s_lo, s_hi, s_w, s_e], pair_cap)
    return _pools_to_state(pm, plo, phi, pw, pe, pair_ovf | extract_ovf, v,
                           caps["comp_cap"], gst.S.reshape(-1),
                           gst.ID.reshape(-1), gst.bucket, gst.flags)


def _pool_roots(pm, plo, phi, pw, pe, v, comp_cap):
    """Deduped pair pool -> two-orientation edge pool (esrc, edst, ew,
    eeid) and the initial-root list: every component with a live edge (the
    others never merge in the compact rounds), front-compacted to comp_cap.
    Returns (pool, rm, r0, root_ovf), r0 holding v (the dropped slot of a
    scatter) past the roots."""
    plo = torch.where(pm, plo, 0)
    phi = torch.where(pm, phi, 0)
    pw = torch.where(pm, pw, torch.inf)
    ew = torch.cat([pw, pw])
    pool = (torch.cat([plo, phi]), torch.cat([phi, plo]), ew,
            torch.cat([pe, pe]))
    srt_src = torch.sort(torch.where(torch.isfinite(ew), pool[0],
                                     INT32_MAX)).values
    rhead = _run_heads(srt_src) & (srt_src != INT32_MAX)
    rm, (r0,), root_ovf = _select_compact(rhead, [srt_src], comp_cap)
    return pool, rm, torch.where(rm, r0, v), root_ovf


def _pools_to_state(pm, plo, phi, pw, pe, pair_ovf, v, comp_cap, SZf, IDf,
                    bucket, base_flags):
    """Deduped pair pool -> stage-2 entry state, plus the initial-root list
    (rm, r0) for the final map. The state carries stage G's bucket: the
    ramp goes on where stage G left it."""
    (esrc, edst, ew, eeid), rm, r0, root_ovf = _pool_roots(
        pm, plo, phi, pw, pe, v, comp_cap)
    flags0 = _raise_flag(_raise_flag(base_flags, pair_ovf, FLAG_PAIR_OVERFLOW),
                         root_ovf, FLAG_COMP_OVERFLOW)
    st = CompactState(esrc=esrc, edst=edst, ew=ew, eeid=eeid, SZf=SZf,
                      IDf=IDf, fin=torch.where(rm, r0, 0), merged=True,
                      it=0, bucket=bucket, phase=0, flags=flags0)
    return st, rm, r0


def _chunked_pair_extract(lo, hi, w4, eid4, pair_cap, chunk=PAIR_CHUNK):
    """Extract the live boundary edges and dedup them per pair, chunk by
    chunk (the fastmst and superpixel handoff): each chunk of `chunk`
    slots is sorted by (lo, hi, w, eid) on its own, its pair heads move to
    its front (a second, stable sort), and the chunk fronts are joined by
    an output-space scan. A pair whose edges span several chunks survives
    once per chunk, as in the reference: stage 2 treats the list as a
    multigraph, so that costs capacity, not labels. Returns (mask, lo, hi,
    w, eid, overflow), arrays of size pair_cap; on overflow the output is
    invalid."""
    dev = lo.device
    n = lo.shape[0]
    nch = pair_chunks(n, chunk)
    pad = nch * chunk - n
    if pad:
        lo = torch.cat([lo, lo.new_full((pad,), INT32_MAX)])
        hi = torch.cat([hi, hi.new_full((pad,), INT32_MAX)])
        w4 = torch.cat([w4, w4.new_full((pad,), torch.inf)])
        eid4 = torch.cat([eid4, eid4.new_zeros(pad)])
    ka = _key64(lo, hi).reshape(nch, chunk)
    kb = _key64(w4, eid4).reshape(nch, chunk)
    perm = torch.sort(kb, dim=1, stable=True).indices
    perm = perm.gather(1, torch.sort(ka.gather(1, perm), dim=1,
                                     stable=True).indices)
    s_lo, s_hi = (x.reshape(nch, chunk).gather(1, perm) for x in (lo, hi))
    head = torch.ones((nch, chunk), dtype=torch.bool, device=dev)
    head[:, 1:] = (s_lo[:, 1:] != s_lo[:, :-1]) | (s_hi[:, 1:] != s_hi[:, :-1])
    head &= s_lo != INT32_MAX
    # heads to each chunk's front, in order
    perm = perm.gather(1, torch.sort((~head).to(torch.uint8), dim=1,
                                     stable=True).indices)
    counts = head.sum(1)
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    # output-space scan: the chunk that owns output slot j
    marks = _scatter(torch.zeros(pair_cap, dtype=torch.int64, device=dev),
                     offsets.clamp(0, pair_cap - 1),
                     torch.arange(nch, device=dev), "amax")
    chunk_of = torch.cummax(marks, 0).values
    j = torch.arange(pair_cap, device=dev)
    src = (chunk_of * chunk + j - offsets[chunk_of]).clamp(0, nch * chunk - 1)
    src = (perm + torch.arange(nch, device=dev)[:, None] * chunk).reshape(
        -1)[src]
    return ((j < total), lo[src], hi[src], w4[src], eid4[src],
            total > pair_cap)


def _hook_roots(hm, hsrc, succ, v):
    """Resolve one round's hooks in compact index space: hm marks the
    component heads, hsrc their labels, succ the label each hooks to (its
    own where it does not hook). Of each mutual pair the smaller label
    stays a root; hook chains resolve by pointer doubling, a fixed step
    count equal to the reference's cap (once converged, further steps
    leave the pointers unchanged, so the result is the same without a
    device->host read per step). Returns (succ without the mutual hooks,
    nr: the hook-chain sink of each head)."""
    dev = hsrc.device
    hsrc_safe = torch.where(hm, hsrc, v)
    iota = torch.arange(v, dtype=torch.int32, device=dev)
    s2 = _gather(_scatter(iota, hsrc_safe, succ), succ)
    mutual = (s2 == hsrc) & (succ != hsrc)
    succ = torch.where(mutual & (hsrc < succ), hsrc, succ)
    cap = hsrc.numel()
    cidx = torch.arange(cap, dtype=torch.int32, device=dev)
    hidx = _scatter(torch.full((v,), INT32_MAX, dtype=torch.int32,
                               device=dev), hsrc_safe, cidx)
    csucc_raw = _gather(hidx, torch.where(hm, succ, 0))
    croot = torch.where(hm & (succ != hsrc) & (csucc_raw != INT32_MAX),
                        csucc_raw, cidx).to(torch.int64)
    for _ in range(max(int(cap).bit_length() + 1, 4)):
        croot = croot[croot]
    return succ, hsrc[croot]


def _s2_round(st: CompactState, v, comp_cap, k, min_size,
              is_felz: bool, tau=None, canonical: bool = True
              ) -> CompactState:
    """One compact round. is_felz: the predicate-gated felz round vs a
    min-size round. tau: the felz round's weight cap (quality mode; None:
    no cap). canonical: relabel each merged cluster to its min member root
    (turbo's labels), else keep the hook-chain sink root (the root-id
    labels of the atomic path and the oracles, which fastmst gives)."""
    esrc, edst, ew = st.esrc, st.edst, st.ew
    dev = esrc.device
    live = (esrc != edst) & torch.isfinite(ew)
    if tau is not None:
        live &= ew <= tau
    k1 = torch.where(live, esrc, INT32_MAX)
    kw = torch.where(live, ew, torch.inf)
    perm = _lexsort(_key64(k1, kw), st.eeid)
    s_src, s_w, s_dst = k1[perm], kw[perm], edst[perm]
    head = _run_heads(s_src) & (s_src != INT32_MAX)
    hm, (hsrc, hw, hdst), head_ovf = _select_compact(
        head, [s_src, s_w, s_dst], comp_cap)

    if is_felz:
        kf = torch.tensor(k, dtype=torch.float32, device=dev)
        lhs_s = (hw - _gather(st.IDf, hsrc)) * _gather(st.SZf, hsrc).float()
        lhs_d = (hw - _gather(st.IDf, hdst)) * _gather(st.SZf, hdst).float()
        ok = (lhs_s <= kf) & (lhs_d <= kf)
    else:
        ok = _gather(st.SZf, hsrc) < min_size
    succ, nr = _hook_roots(hm, hsrc, torch.where(hm & ok, hdst, hsrc), v)
    hsrc_safe = torch.where(hm, hsrc, v)
    iota = torch.arange(v, dtype=torch.int32, device=dev)

    if canonical:
        # relabel each cluster to its min member root.
        canon = _scatter(torch.full((v,), INT32_MAX, dtype=torch.int32,
                                    device=dev),
                         torch.where(hm, nr, v),
                         torch.where(hm, hsrc, INT32_MAX), "amin")
        nr_canon = torch.where(hm, _gather(canon, nr), hsrc)
    else:
        nr_canon = nr
    changed = hm & (nr_canon != hsrc)

    M = _scatter(iota, hsrc_safe, nr_canon)
    tgt = torch.where(changed, nr_canon, v)
    SZf = _scatter(st.SZf, tgt,
                   torch.where(changed, _gather(st.SZf, hsrc), 0), "sum")
    IDf = _scatter(st.IDf, tgt,
                   torch.where(changed, _gather(st.IDf, hsrc), 0.0), "amax")
    # used hook edges contribute their weight to the new root's Int.
    used = hm & (succ != hsrc)
    IDf = _scatter(IDf, torch.where(used, nr_canon, v),
                   torch.where(used, hw, 0.0), "amax")

    return CompactState(
        esrc=M[esrc.to(torch.int64)], edst=M[edst.to(torch.int64)],
        ew=st.ew, eeid=st.eeid, SZf=SZf, IDf=IDf,
        fin=M[st.fin.to(torch.int64)],
        merged=bool(changed.any()), it=st.it + 1, bucket=st.bucket,
        phase=st.phase,
        flags=_raise_flag(st.flags, head_ovf, FLAG_COMP_OVERFLOW))


def _s2_phase(st: CompactState, v, comp_cap, k, min_size, max_iters,
              thresholds, with_minsize: bool, flag_exhaustion: bool = True,
              capture=None, canonical: bool = True):
    """Felz rounds to convergence, then (optionally) min-size rounds; the
    phase flips 0 -> 1 when a felz round merges nothing with every bucket
    open. thresholds: the bucket caps (quality mode) or None.
    flag_exhaustion=False for deliberately round-capped warm-up phases.
    capture: called with the root map `fin` after each felz round (the
    hierarchy's levels; min-size rounds refine the last level).
    canonical: see _s2_round."""
    nb = 1 if thresholds is None else thresholds.numel()
    st = st._replace(merged=True, it=0)
    while st.merged and st.it < max_iters:
        is_felz = st.phase == 0
        tau = (thresholds[st.bucket]
               if is_felz and thresholds is not None else None)
        s2 = _s2_round(st, v, comp_cap, k, min_size, is_felz, tau,
                       canonical)
        if is_felz:
            # bucket ramp: the cap rises one bucket per felz round.
            s2 = s2._replace(bucket=min(st.bucket + 1, nb - 1),
                             merged=s2.merged or st.bucket + 1 < nb)
            if capture is not None:
                capture(s2.fin)
        if with_minsize and is_felz and not s2.merged:
            s2 = s2._replace(phase=1, merged=True)
        st = s2
    if flag_exhaustion and st.merged:
        # the round budget ended the loop early.
        st = st._replace(flags=st.flags | FLAG_ITERS_EXHAUSTED)
    return st


def _recompact_edges(st: CompactState, cap):
    """Dedup + shrink the edge buffers to a smaller capacity."""
    o1, o2, ow, oe, ovf = _pair_dedup(st.esrc, st.edst, st.ew, st.eeid, cap)
    return st._replace(esrc=o1, edst=o2, ew=ow, eeid=oe), ovf


def _prune_dead(st: CompactState, v, k, min_size):
    """Kill edges that can never take part in another merge (lossless).

    A component is frozen when (min outgoing w - Int) * |C| > k: no felz
    round can merge it again. An edge is dead when both endpoints are
    frozen and neither is small (min-size rounds only hook from small
    components, and the small[edst] term keeps every min-size hook target
    a head). Returns st with dead edges' weights set to +inf."""
    live = (st.esrc != st.edst) & torch.isfinite(st.ew)
    key = torch.where(live, st.esrc, INT32_MAX)
    kw = torch.where(live, st.ew, torch.inf)
    perm = torch.sort(_key64(key, kw), stable=True).indices
    s_src, s_w = key[perm], kw[perm]
    head = _run_heads(s_src) & (s_src != INT32_MAX)
    minw = _scatter(torch.full((v,), torch.inf, dtype=torch.float32,
                               device=key.device),
                    torch.where(head, s_src, v), s_w, "amin")
    kf = torch.tensor(k, dtype=torch.float32, device=key.device)
    frozen = (minw - st.IDf) * torch.clamp(st.SZf.to(torch.float32),
                                           min=1.0) > kf
    small = st.SZf < min_size
    src, dst = st.esrc.to(torch.int64), st.edst.to(torch.int64)
    keep = ~(frozen[src] & frozen[dst]) | small[src] | small[dst]
    return st._replace(ew=torch.where(live & ~keep, torch.inf, st.ew))


def _slice_pool(st: CompactState, pair_cap: int, cs: int) -> CompactState:
    """Slice the two-orientation pool to `cs` pairs per half (each half is
    front-compacted, so this keeps every live pair when live <= cs)."""
    def take(x):
        return torch.cat([x[:cs], x[pair_cap:pair_cap + cs]])

    return st._replace(esrc=take(st.esrc), edst=take(st.edst),
                       ew=take(st.ew), eeid=take(st.eeid))


def _s2_stage(st: CompactState, v: int, cfg: SegmentationConfig,
              thresholds=None):
    """All stage-2 compact rounds. Speed mode: warm-up round, recompact,
    two rounds, prune, recompact, then the main phase with the min-size
    rounds. Quality mode (thresholds: the bucket caps): two warm-up rounds,
    recompact, then the main phase."""
    quality = cfg.weight_buckets > 0
    comp_cap = (v if v <= 1 << 20
                else capacities(v, cfg.weight_buckets)["comp_cap"])
    caps = _s2_capacities(v, quality)
    rec1_cap = caps["rec1_cap"]
    s2_iters = 2 * cfg.max_iters + max(cfg.weight_buckets, 1)

    def early(s: CompactState) -> CompactState:
        s = _s2_phase(s, v, comp_cap, cfg.k, cfg.min_size,
                      2 if quality else 1, thresholds, with_minsize=False,
                      flag_exhaustion=False)
        s, rec_ovf = _recompact_edges(s, rec1_cap)
        s = s._replace(flags=_raise_flag(s.flags, rec_ovf,
                                         FLAG_RECOMPACT_OVERFLOW))
        if quality:
            return s
        s = _s2_phase(s, v, comp_cap, cfg.k, cfg.min_size, 2, thresholds,
                      with_minsize=False, flag_exhaustion=False)
        s = _prune_dead(s, v, cfg.k, cfg.min_size)
        s, rec2_ovf = _recompact_edges(s, caps["rec2_cap"])
        return s._replace(flags=_raise_flag(s.flags, rec2_ovf,
                                            FLAG_RECOMPACT_OVERFLOW))

    # live-count small path: when every live pair fits a much smaller
    # slice, run the same early rounds on the sliced pool (dead slots past
    # the slice carry no information).
    pair_cap = st.esrc.numel() // 2
    cs = max(v // caps["small_div"], -(-rec1_cap // 2))
    if (_S2_SMALL and cs < pair_cap
            and int(torch.isfinite(st.ew[:pair_cap]).sum()) <= cs):
        st = early(_slice_pool(st, pair_cap, cs))
    else:
        st = early(st)
    return _s2_phase(st, v, comp_cap if quality else caps["comp_cap2"],
                     cfg.k, cfg.min_size, s2_iters, thresholds,
                     with_minsize=cfg.min_size > 1)


def _value_flood(L, seed, max_sweeps, closures=False, comm=DENSE):
    """The final map's value flood: the wrapper on one device (closures:
    its hybrid route), the spatial fixpoint on a row tile. Returns (labels,
    unconverged)."""
    if comm.dense:
        return kg.value_flood(L, seed, max_sweeps, closures=closures)
    return kg.value_flood_spatial(L, seed, max_sweeps, comm.rank)


def _root_gather(table, L):
    """Each pixel's entry of a (V,) root table: L holds root ids."""
    return table[L.reshape(-1).to(torch.int64)].reshape(L.shape)


def _final_map(gst: GossipState, st: CompactState, rm, r0, max_sweeps,
               closures=False):
    """Stage-G labels through the stage-2 root map -> final (H, W) labels:
    each root pixel holds its final label (its own id when stage 2 never
    saw it), and a value flood spreads it over the stage-G component
    (closures: its hybrid route, quality mode); under `_FINAL_GATHER`
    each pixel gathers its root's slot instead. Returns (labels,
    unconverged)."""
    h, w = gst.L.shape
    v = h * w
    vid2d = torch.arange(v, dtype=torch.int32,
                         device=gst.L.device).reshape(h, w)
    seed = torch.where(gst.L == vid2d, gst.L, INT32_MAX).reshape(-1)
    seed = _scatter(seed, r0, st.fin)  # r0 holds v (dropped) where ~rm
    if _FINAL_GATHER:
        return _root_gather(seed, gst.L), False
    return _value_flood(gst.L, seed.reshape(h, w), max_sweeps, closures)


def segment_turbo_impl(image: torch.Tensor, cfg: SegmentationConfig,
                       gossip_rounds: int = 2, weights_override=None):
    """(H, W, 3) tensor -> (labels, flags): (H, W) int32 canonical
    (min-vertex-id) labels on the image's device, plus an int FLAG_* mask —
    nonzero means a capacity or sweep-budget violation, and the labels
    must not be trusted (`segment_turbo` checks it).

    weights_override: see _stage_g (parity-testing hook)."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    gst, weights, thresholds = _stage_g(image, cfg, gossip_rounds,
                                        weights_override)
    st, rm, r0 = _extract_stage(gst, weights, cfg)
    st = _s2_stage(st, v, cfg, thresholds)
    labels, fm_unconv = _final_map(
        gst, st, rm, r0, 4 * (h + w),
        closures=cfg.weight_buckets > 0 and _Q_CLOSURES)
    flags = _raise_flag(st.flags, fm_unconv, FLAG_GOSSIP_UNCONVERGED)
    return labels, int(flags)


segment_turbo_flagged = segment_turbo_impl


# ---------------------------------------------------------------------------
# Hierarchy mode: a label capture per felz round (the reference's segment-
# ation-hierarchy output). Stage-G rounds capture the label plane; stage-2
# rounds capture the compact root map `fin`, rendered as the final map is:
# the root pixels seeded, then a value flood.
# ---------------------------------------------------------------------------


def segment_turbo_hierarchy_impl(image: torch.Tensor, cfg: SegmentationConfig,
                                 gossip_rounds: int = 2,
                                 n_levels: int | None = None):
    """(H, W, 3) tensor -> (levels, labels, flags): levels (n_levels + 1,
    H, W) int32 on the image's device, level 0 the trivial partition, level
    i the partition after felz round i, levels past convergence repeating
    the last felz partition; labels the final map after the min-size
    rounds; flags an int FLAG_* mask. Labels are canonical min-vertex ids.
    n_levels: default cfg.max_iters."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    if n_levels is None:
        n_levels = cfg.max_iters
    quality = cfg.weight_buckets > 0
    max_sweeps = 4 * (h + w)

    glevels = [None] * n_levels

    def on_round(it, L):
        glevels[min(it, n_levels - 1)] = L

    gst, weights, thresholds = _stage_g(image, cfg, gossip_rounds,
                                        capture=on_round)
    g_count = min(gst.it, n_levels)
    st, rm, r0 = _extract_stage(gst, weights, cfg)

    # the reference's hierarchy keeps the default gates' root list
    comp_cap = (v if v <= 1 << 20
                else max(v // (24 if quality else 96), _CAP_FLOOR))
    fins, cur = [None] * n_levels, 0

    def on_felz(fin):
        nonlocal cur
        fins[min(cur, n_levels - 1)] = fin
        cur += 1

    st = _s2_phase(st, v, comp_cap, cfg.k, cfg.min_size, 2 if quality else 1,
                   thresholds, with_minsize=False, flag_exhaustion=False,
                   capture=on_felz)
    st, rec_ovf = _recompact_edges(
        st, max(v // (16 if quality else 64), _CAP_FLOOR))
    st = st._replace(flags=_raise_flag(st.flags, rec_ovf,
                                       FLAG_RECOMPACT_OVERFLOW))
    st = _s2_phase(st, v, comp_cap, cfg.k, cfg.min_size,
                   2 * cfg.max_iters + max(cfg.weight_buckets, 1),
                   thresholds, with_minsize=cfg.min_size > 1,
                   capture=on_felz)
    # unwritten slots repeat the last captured felz root map (the warm-up
    # phase always runs a felz round, so one was captured).
    last = fins[min(cur, n_levels) - 1]
    fins = [f if i < cur else last for i, f in enumerate(fins)]

    vid2d = torch.arange(v, dtype=torch.int32,
                         device=gst.L.device).reshape(h, w)
    seed_base = torch.where(gst.L == vid2d, gst.L, INT32_MAX).reshape(-1)
    rendered = {}  # a root map repeated past convergence renders once

    def render_fin(fin):
        if id(fin) not in rendered:
            seed = _scatter(seed_base, r0, fin)  # r0 holds v where ~rm
            rendered[id(fin)] = (
                (_root_gather(seed, gst.L), False) if _FINAL_GATHER
                else kg.value_flood(gst.L, seed.reshape(h, w), max_sweeps,
                                    closures=quality and _Q_CLOSURES))
        return rendered[id(fin)]

    levels = torch.empty((n_levels + 1, h, w), dtype=torch.int32,
                         device=gst.L.device)
    levels[0] = vid2d
    unconv = False
    for j in range(n_levels):
        if j < g_count:
            levels[j + 1] = glevels[j]
        else:
            lab, lv_unconv = render_fin(fins[min(j - g_count, n_levels - 1)])
            levels[j + 1] = lab
            unconv = unconv or lv_unconv
    # the reference's final map here takes the hybrid route in speed mode
    # too; the results are the same either way.
    labels, fm_unconv = _final_map(gst, st, rm, r0, max_sweeps,
                                   closures=True)
    flags = _raise_flag(st.flags, unconv or fm_unconv,
                        FLAG_GOSSIP_UNCONVERGED)
    return levels, labels, int(flags)


segment_turbo_hierarchy_flagged = segment_turbo_hierarchy_impl


def describe_flags(flags: int) -> str:
    names = {
        FLAG_GOSSIP_UNCONVERGED: "gossip sweep cap exhausted",
        FLAG_PAIR_OVERFLOW: "pair-extraction capacity overflow",
        FLAG_COMP_OVERFLOW: "component-head capacity overflow",
        FLAG_RECOMPACT_OVERFLOW: "edge-recompaction capacity overflow",
        FLAG_ITERS_EXHAUSTED: "stage-2 round budget exhausted",
    }
    hits = [msg for bit, msg in names.items() if flags & bit]
    return "; ".join(hits) if hits else "ok"


def segment_turbo_hierarchy(image: torch.Tensor, cfg: SegmentationConfig,
                            gossip_rounds: int = 2):
    """Checked hierarchy entry: (H, W, 3) -> (levels (L + 1, H, W), labels).

    On a nonzero flag mask: per cfg.on_overflow this raises RuntimeError
    ("raise"), returns anyway ("ignore"), or routes to the fastmst
    hierarchy ("fallback", whose labels are root vertex ids and whose
    levels are n_levels + 2)."""
    levels, labels, flags = segment_turbo_hierarchy_flagged(
        image, cfg, gossip_rounds)
    if flags == 0 or cfg.on_overflow == "ignore":
        return levels, labels
    if cfg.on_overflow == "fallback":
        from .fastmst import segment_fastmst_hierarchy

        return segment_fastmst_hierarchy(image, cfg)
    raise RuntimeError(
        f"turbo capacity/budget violation: {describe_flags(flags)} — rerun "
        "with SegmentationConfig(on_overflow='fallback') to route to the "
        "fastmst hierarchy, or use a larger-capacity config")


def segment_turbo(image: torch.Tensor, cfg: SegmentationConfig,
                  gossip_rounds: int = 2) -> torch.Tensor:
    """Checked turbo entry: (H, W, 3) -> (H, W) int32 labels.

    On a nonzero flag mask the result is not a valid segmentation: per
    cfg.on_overflow this raises RuntimeError ("raise"), returns anyway
    ("ignore"), or falls back to the capacity-unbounded atomic path
    ("fallback", whose labels are root vertex ids)."""
    labels, flags = segment_turbo_flagged(image, cfg, gossip_rounds)
    if flags == 0 or cfg.on_overflow == "ignore":
        return labels
    if cfg.on_overflow == "fallback":
        from .atomic_boruvka import segment_atomic

        return segment_atomic(image, cfg)
    raise RuntimeError(
        f"turbo capacity/budget violation: {describe_flags(flags)} — rerun "
        "with SegmentationConfig(on_overflow='fallback') to route to the "
        "atomic path, or use a larger-capacity config")

"""Data-parallel primitives of the atomic path (port of
`gseg_tpu.ops.primitives`).

The reference's XLA scatters and gathers become torch's:
  - `.at[idx].min/max/add(..., mode="drop")` -> `scatter_reduce_` /
    `index_add_` on a base one slot longer, with out-of-range indices sent
    to that slot and the slot cut off again;
  - the pointer-doubling `lax.while_loop` -> a fixed count of doubling
    steps equal to the reference's cap (steps past convergence leave the
    pointers as they are, so the result is the same without a
    device-to-host read per step).
Every primitive is deterministic: min and max scatters do not depend on
the order of the updates, and ties resolve by canonical edge id. The three
stream compactions (`block_compact`, `sparse_select`, `compact_indices`)
have no caller in either package's models; they are ported so the module
is whole.
"""

from __future__ import annotations

import torch

from .grid_graph import INT32_MAX


def scatter_drop(base: torch.Tensor, idx: torch.Tensor, vals,
                  reduce: str) -> torch.Tensor:
    """base.at[idx].<reduce>(vals, mode="drop") for a 1-D base: negative
    indices count from the end, as in NumPy, and indices still outside
    [0, len(base)) are dropped. reduce: "amin", "amax" or "sum"."""
    n = base.numel()
    ext = torch.cat([base, base.new_zeros(1)])
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    if reduce == "sum":
        ext.index_add_(0, idx, vals.to(base.dtype))
    else:
        ext.scatter_reduce_(0, idx, vals.to(base.dtype), reduce)
    return ext[:n]


def pointer_double(parent: torch.Tensor,
                   max_rounds: int | None = None) -> torch.Tensor:
    """Flatten a parent forest: out[v] = root of v, by parent = parent[parent]
    doubling. The reference stops at convergence or after `max_rounds`
    (default ceil(log2 of the longest possible chain) + 1) steps; this runs
    the cap's count of steps, which gives the same pointers."""
    n = parent.shape[0]
    if max_rounds is None:
        max_rounds = max(int(n - 1).bit_length(), 1) + 1
    p = parent.to(torch.int64)
    for _ in range(max_rounds):
        p = p[p]
    return p.to(parent.dtype)


def component_min_edge(roots: torch.Tensor, vert_minw: torch.Tensor,
                       vert_eid: torch.Tensor, num_slots: int):
    """Per-component minimum outgoing edge by a two-phase scatter-min:
    phase 1 takes the min float32 weight per component, phase 2 the min
    canonical edge id among the vertices whose weight ties it (ties go to
    the smallest edge id).

    roots: (V,) int32 component id (root vertex) per vertex. vert_minw:
    (V,) float32 best outgoing weight per vertex (+inf if none). vert_eid:
    (V,) int32 its canonical edge id (INT32_MAX if none). Returns
    (comp_minw, comp_eid), each (num_slots,), +inf / INT32_MAX where a
    component has no outgoing edge (and at non-root slots).

    A lane whose value cannot lower a slot (+inf, INT32_MAX: a vertex
    inside its component) scatters into a slot of its own, not its
    component's. The result is the same, but the scatters no longer
    serialise on the roots of large components, so a round's time does
    not follow the sizes of the image's regions."""
    dev = roots.device
    own = torch.arange(roots.shape[0], dtype=roots.dtype, device=dev)
    if roots.shape[0] > num_slots:
        own = own % num_slots
    comp_minw = scatter_drop(
        torch.full((num_slots,), torch.inf, dtype=vert_minw.dtype,
                   device=dev),
        torch.where(vert_minw == torch.inf, own, roots), vert_minw, "amin")
    is_best = vert_minw == comp_minw[roots.to(torch.int64)]
    cand = torch.where(is_best, vert_eid, INT32_MAX)
    comp_eid = scatter_drop(
        torch.full((num_slots,), INT32_MAX, dtype=torch.int32, device=dev),
        torch.where(cand == INT32_MAX, own, roots), cand, "amin")
    return comp_minw, comp_eid


def remove_mutual_hooks(succ: torch.Tensor) -> torch.Tensor:
    """Break 2-cycles in a successor array: of each mutual pair, the smaller
    id becomes a root."""
    idx = torch.arange(succ.shape[0], dtype=succ.dtype, device=succ.device)
    mutual = (succ[succ.to(torch.int64)] == idx) & (succ != idx)
    return torch.where(mutual & (idx < succ), idx, succ)


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_slots: int) -> torch.Tensor:
    out = torch.zeros((num_slots,), dtype=values.dtype, device=values.device)
    return scatter_drop(out, seg, values, "sum")


def segment_max(values: torch.Tensor, seg: torch.Tensor, num_slots: int,
                fill=0.0) -> torch.Tensor:
    out = torch.full((num_slots,), fill, dtype=values.dtype,
                     device=values.device)
    return scatter_drop(out, seg, values, "amax")


def block_compact(mask: torch.Tensor, arrays, out_elems: int,
                  block: int = 64):
    """Stream compaction at `block`-lane granularity: every window of
    `block` lanes that holds a live element moves whole, in order, to the
    front of (out_elems,) buffers (a multiple of `block`); dead lanes stay
    as they are, masked. Windows past the capacity are dropped and flagged.
    Returns (out_mask (out_elems,), outs (same dtypes), overflow)."""
    n = mask.shape[0]
    pad = (-n) % block
    if pad:
        mask = torch.cat([mask, mask.new_zeros(pad)])
        arrays = [torch.cat([a, a.new_zeros(pad)]) for a in arrays]
    nb = (n + pad) // block
    out_rows = out_elems // block
    m2 = mask.reshape(nb, block)
    win = m2.any(1)
    pos = torch.cumsum(win.to(torch.int32), 0) - 1
    slot = torch.where(win, pos, out_rows)
    widx = scatter_set(torch.full((out_rows,), nb, dtype=torch.int64,
                                  device=mask.device), slot,
                       torch.arange(nb, device=mask.device))
    overflow = win.sum() > out_rows
    outs = [torch.cat([a.reshape(nb, block), a.new_zeros(1, block)])[widx]
            .reshape(-1) for a in arrays]
    m3 = torch.cat([m2, m2.new_zeros(1, block)])[widx]
    return m3.reshape(-1), outs, overflow


def sparse_select(mask: torch.Tensor, arrays, cap: int):
    """Compact a sparse mask's elements, in order, to the front of
    (cap,) buffers (zero past the count) by a running count and a binary
    search per output slot. Returns (out_mask (cap,), outs, overflow)."""
    counts = torch.cumsum(mask.to(torch.int32), 0)
    total = counts[-1]
    ranks = torch.arange(1, cap + 1, dtype=torch.int32, device=mask.device)
    pos = torch.searchsorted(counts, ranks, side="left")
    valid = ranks <= total
    pos_safe = torch.where(valid, pos, 0)
    outs = [torch.where(valid, a[pos_safe], 0).to(a.dtype) for a in arrays]
    return valid, outs, total > cap


def compact_indices(mask: torch.Tensor, capacity: int):
    """Indices of the True entries in order, in a (capacity,) int32 buffer
    holding INT32_MAX past them, and their count (0-d int32)."""
    m = mask.to(torch.int32)
    pos = torch.cumsum(m, 0, dtype=torch.int32) - m
    slot = torch.where(mask, pos, capacity)
    out = scatter_set(torch.full((capacity,), INT32_MAX, dtype=torch.int32,
                                 device=mask.device), slot,
                      torch.arange(mask.shape[0], dtype=torch.int32,
                                   device=mask.device))
    return out, m.sum(dtype=torch.int32)


def scatter_set(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    """base.at[idx].set(vals, mode="drop") for a 1-D base, for indices that
    are unique within [0, len(base)) (the others are dropped)."""
    n = base.numel()
    idx = idx.to(torch.int64)
    ext = torch.cat([base, base.new_zeros(1)])
    ext.scatter_(0, torch.where((idx >= 0) & (idx < n), idx, n),
                 vals.to(base.dtype))
    return ext[:n]

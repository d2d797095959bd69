"""Spatial parallelism on the atomic path: one image row-sharded over the
ranks of a mesh (port of `gseg_tpu/parallel/spatial.py`).

The reference jits the atomic pipeline with sharded inputs and lets XLA's
SPMD partitioner insert the collectives. The port writes them out
(`parallel.mesh`):

  - each rank prepares its rows' incident views (`w8`, `eid8`) from the
    tile with a halo, with the dense arithmetic and global edge ids, as
    `parallel.turbo_spatial` does;
  - each rank keeps the V-sized `parent`, `size` and `intdiff` replicated;
  - per round (`models/atomic_boruvka.py`): the per-vertex min edge on the
    rank's own rows, reading the neighbour roots from the replicated
    `parent`; both phases of `component_min_edge` as a local scatter-min
    into V slots followed by `all_reduce_min`; then the rest of the round
    replicated (`atomic_boruvka._hook_round`).

The labels are root vertex ids byte-equal to `segment_atomic`'s: the same
function, computed with the same operations. Memory: the replicated state
is three V-sized vectors per rank, plus the two V-sized slot vectors of
each reduction.
"""

from __future__ import annotations

import torch

from ..config import SegmentationConfig
from ..models import atomic_boruvka as ab
from ..ops import grid_graph as gg
from ..ops.primitives import INT32_MAX, scatter_drop
from .mesh import (Mesh, as_tensor, axis_devices, default_devices, row_tiles,
                   run_ranks)
from .turbo_spatial import _rank_graph


def spatial_mesh(devices=None, axis: str = "space") -> Mesh:
    """A 1-D mesh over `devices` (default: every CUDA device, as the
    reference defaults to `jax.devices()`; raises without one). A device
    may repeat: `spatial_mesh(["cuda:0"] * 4)` runs four ranks on one card,
    `spatial_mesh(["cpu"] * 8)` eight on the CPU."""
    return Mesh(default_devices() if devices is None else devices, (axis,))


def _round_spatial(state, rank, w8, eid8, row_off, shape, k, min_size,
                   mode):
    """One Boruvka round over a row tile's vertices; the result is the same
    on every rank."""
    h_glob, w = shape
    h = w8.shape[1]
    v = h_glob * w
    parent2d = state.parent.reshape(h_glob, w)
    lo, hi = max(row_off - 1, 0), min(row_off + h + 1, h_glob)
    win = parent2d[lo:hi]
    a = row_off - lo
    nbr = torch.stack([gg.shift_plane(win, dy, dx, -1)[a:a + h]
                       for dy, dx in gg.DIRS8])
    roots2d = win[a:a + h]
    vminw, veid = ab._vertex_min_edge(w8, eid8, roots2d, nbr)
    roots = roots2d.reshape(-1)
    dev = roots.device
    comp_minw = rank.all_reduce_min(scatter_drop(
        torch.full((v,), torch.inf, dtype=vminw.dtype, device=dev), roots,
        vminw, "amin"))
    is_best = vminw == comp_minw[roots.to(torch.int64)]
    comp_eid = rank.all_reduce_min(scatter_drop(
        torch.full((v,), INT32_MAX, dtype=torch.int32, device=dev), roots,
        torch.where(is_best, veid, INT32_MAX), "amin"))
    return ab._hook_round(state, comp_minw, comp_eid, w, k, min_size, mode)


def _atomic_rank(rank, tile, cfg: SegmentationConfig, h_glob: int):
    w = tile.shape[1]
    row_off, _, _, _, w8, eid8 = _rank_graph(rank, tile, cfg, h_glob)
    state = ab._init_state(h_glob * w, tile.device)
    modes = ["felz"] + (["minsize"] if cfg.min_size > 1 else [])
    for mode in modes:
        state = state._replace(merged=True, it=0)
        while state.merged and state.it < cfg.max_iters:
            state = _round_spatial(state, rank, w8, eid8, row_off,
                                   (h_glob, w), cfg.k, cfg.min_size, mode)
    return state.parent.reshape(h_glob, w)


def segment_spatial(image, cfg: SegmentationConfig, mesh: Mesh,
                    axis: str = "space") -> torch.Tensor:
    """Segment one (H, W, 3) image row-sharded over the ranks of `mesh`'s
    axis `axis` (H divisible by its size) on the atomic path. Returns (H,
    W) int32 labels on the mesh's first device: root vertex ids, byte-equal
    to `segment_atomic`'s."""
    devices = axis_devices(mesh, axis)
    h = as_tensor(image).shape[0]
    out = run_ranks(devices,
                    lambda rank, tile: _atomic_rank(rank, tile, cfg, h),
                    row_tiles(image, devices))
    return out[0]


def multichip_step(images, cfg: SegmentationConfig, mesh: Mesh,
                   batch_axis: str = "data", space_axis: str = "space"):
    """The multi-device step over a 2-D (data x space) mesh: the (B, H, W,
    3) batch is split in order over `batch_axis` (B divisible by its size),
    and each image is segmented by `segment_spatial` over its row of ranks
    along `space_axis`. Each data row is a thread of its own that meets
    no collective before its last image, so it holds the turn
    (`mesh._Group`) through its whole share: the rows run one after
    another, and the data axis adds no speed-up. Returns one (B / n_data,
    H, W) int32 block of labels per data row, in order, each on its row's
    first device (root vertex ids, as `segment_atomic`'s)."""
    images = as_tensor(images)
    groups = mesh.groups(space_axis)
    nd = len(groups)
    if mesh.shape.get(batch_axis) != nd:
        raise ValueError(f"{mesh}: expected axes {batch_axis!r} and "
                         f"{space_axis!r}")
    b = images.shape[0]
    if b % nd:
        raise ValueError(f"batch of {b} not divisible by mesh axis "
                         f"{batch_axis!r} of size {nd}")
    per = b // nd

    def row(_, g):
        sub = Mesh(groups[g], (space_axis,))
        return torch.stack([segment_spatial(images[i], cfg, sub, space_axis)
                            for i in range(g * per, (g + 1) * per)])

    return run_ranks([g[0] for g in groups], row, range(nd))

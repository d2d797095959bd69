"""Ordered scatter-add of float32 rows (the superpixel path's colour sums).

A helper with no TPU kernel behind it: `base.at[idx].add(vals,
mode="drop")` as XLA:CPU computes it, each slot's updates added one after
another in index order, so the float sums are bit-equal to the
reference's and the same on every run (torch's CUDA scatters add with
atomics, in the order they land). With:

  - the kernel: `csrc/scatter.cu` (the wrapper sorts the targets stably
    and copies base; one thread per run of equal targets adds the run's
    rows in order);
  - the plain PyTorch version: the same stable sort, then one vectorised
    add per rank within the runs (every target's first update, then every
    target's second, ...), one host read of the run lengths.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel. `ordered_scatter_add.launches` counts launches.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ...utils.timing import host_read
from . import _build

MAX_COLS = 4   # csrc/scatter.cu, MAX_C


def _check(base, idx, vals):
    if (base.dtype != torch.float32 or vals.dtype != torch.float32
            or base.dim() != 2 or vals.dim() != 2
            or vals.shape[1] != base.shape[1] or idx.dim() != 1
            or idx.shape[0] != vals.shape[0]
            or idx.dtype not in (torch.int32, torch.int64)):
        raise ValueError(
            "ordered_scatter_add: expected float32 base (V, C), int idx (n,)"
            f" and float32 vals (n, C); got {base.dtype} "
            f"{tuple(base.shape)}, {idx.dtype} {tuple(idx.shape)}, "
            f"{vals.dtype} {tuple(vals.shape)}")
    if not 1 <= base.shape[1] <= MAX_COLS:
        raise ValueError(f"ordered_scatter_add: rows of 1 to {MAX_COLS} "
                         f"floats, got {base.shape[1]}")


def _sorted_targets(idx, slots):
    """Targets outside [0, slots) become `slots` (dropped); a stable sort
    puts each target's updates in one run, in index order."""
    key = torch.where((idx >= 0) & (idx < slots), idx, slots).to(torch.int32)
    return torch.sort(key, stable=True)


def ordered_scatter_add_plain(base, idx, vals):
    """Returns base.at[idx].add(vals, mode="drop"), each slot's updates
    added in index order."""
    slots = base.shape[0]
    sidx, order = _sorted_targets(idx, slots)
    n = host_read((sidx < slots).sum(), "scatter_live")
    sidx, order = sidx[:n].long(), order[:n]
    pos = torch.arange(n, device=base.device)
    head = torch.ones(n, dtype=torch.bool, device=base.device)
    head[1:] = sidx[1:] != sidx[:-1]
    rank = pos - torch.cummax(torch.where(head, pos, 0), 0).values
    by_rank = torch.sort(rank, stable=True).indices
    out = base.clone()
    start = 0
    for count in torch.bincount(rank).tolist():
        sel = by_rank[start:start + count]
        t = sidx[sel]
        out[t] = out[t] + vals[order[sel]]
        start += count
    return out


def _kernel():
    lib = _build.load("scatter")
    fn = lib.gseg_ordered_scatter_add
    if not getattr(lib, "gseg_bound", False):
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gseg_bound = True
    return fn


def ordered_scatter_add(base, idx, vals):
    """base (V, C) float32, idx (n,) int32/int64 targets (those outside
    [0, V) are dropped), vals (n, C) float32. Returns a new (V, C) tensor:
    base with every update's row added to its target's, each target's
    updates in index order."""
    _check(base, idx, vals)
    if _build.on_cpu(base, idx, vals):
        return ordered_scatter_add_plain(base, idx, vals)
    if not (base.is_contiguous() and vals.is_contiguous()):
        raise ValueError("ordered_scatter_add: the kernel takes contiguous "
                         "rows")
    slots, c = base.shape
    sidx, order = _sorted_targets(idx, slots)
    out = base.clone()
    dev = base.get_device()
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = _kernel()(sidx.data_ptr(), order.data_ptr(), vals.data_ptr(),
                        out.data_ptr(), sidx.numel(), c, slots,
                        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gseg_ordered_scatter_add")
    _build.count(_WRAPPER)
    return out


# the launch count lives on the wrapper object (bound here, so a caller that
# re-binds the module name still counts on the original).
_WRAPPER = ordered_scatter_add
_WRAPPER.launches = 0

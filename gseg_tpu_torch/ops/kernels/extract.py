"""Boundary-edge extraction for the turbo handoff.

Port of `gseg_tpu/ops/pallas/extract.py:boundary_extract`, with:

  - the kernel: `csrc/extract.cu` (one block per image row: a segmented
    min-scan gives each run's exact lexmin (w, eid) at its tail, and a
    block claims the slots of a tile's entries with one atomic; the same C
    entry first writes the sentinels and zeroes the count);
  - the plain PyTorch version: a row-run id from a cumsum, and a
    `scatter_reduce(amin)` on an int64 key packed as (float32 bits of w)
    << 32 | eid (w >= 0, so the bits order like the floats).

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel. `boundary_extract.launches` counts launches.

Live boundary edge: finite weight, endpoint in the image, distinct labels.
A run is a maximal sequence of consecutive live edges of one canonical
plane, within one image row, sharing (lo, hi); each run yields one entry
(lo, hi, run-min w, run-min eid). Entries fill slots [0, count) in no
particular order; slots past them hold lo = hi = eid = INT32_MAX and
w = +inf. `count` is exact; `overflow` is count > cap (entries past the
capacity are dropped, and the caller must treat the pool as invalid).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .. import grid_graph as gg
from ...utils.timing import host_read
from . import _build

INT32_MAX = gg.INT32_MAX


def _empty_pool(cap, device):
    return (torch.full((cap,), INT32_MAX, dtype=torch.int32, device=device),
            torch.full((cap,), INT32_MAX, dtype=torch.int32, device=device),
            torch.full((cap,), torch.inf, dtype=torch.float32, device=device),
            torch.full((cap,), INT32_MAX, dtype=torch.int32, device=device))


def boundary_extract_plain(L, weights, cap: int):
    """Returns (lo, hi, w, eid, count, overflow); see the module note."""
    h, w = L.shape
    v = h * w
    vid = torch.arange(v, dtype=torch.int32, device=L.device).reshape(h, w)
    outs = []
    for d, (dy, dx) in enumerate(gg.DIRS4):
        lb = gg.shift_plane(L, dy, dx, -1)
        wd = weights[d]
        live = gg.valid_plane(h, w, dy, dx, L.device) & torch.isfinite(wd) \
            & (L != lb)
        lo = torch.where(live, torch.minimum(L, lb), INT32_MAX)
        hi = torch.where(live, torch.maximum(L, lb), INT32_MAX)
        prev_same = torch.zeros_like(live)
        prev_same[:, 1:] = live[:, 1:] & live[:, :-1] \
            & (lo[:, 1:] == lo[:, :-1]) & (hi[:, 1:] == hi[:, :-1])
        next_same = torch.zeros_like(live)
        next_same[:, :-1] = prev_same[:, 1:]
        head = (live & ~prev_same).reshape(-1)
        tail = (live & ~next_same).reshape(-1)
        run = torch.cumsum(head.to(torch.int64), 0) - 1
        eid = (vid * 4 + d).reshape(-1).to(torch.int64)
        key = (wd.reshape(-1).view(torch.int32).to(torch.int64) << 32) | eid
        livef = live.reshape(-1)
        nrun = host_read(head.sum(), "extract_runs")
        runmin = torch.full((nrun,), torch.iinfo(torch.int64).max,
                            dtype=torch.int64, device=L.device)
        runmin.scatter_reduce_(0, run[livef], key[livef], "amin")
        kmin = runmin[run[tail]]
        outs.append((lo.reshape(-1)[tail], hi.reshape(-1)[tail],
                     (kmin >> 32).to(torch.int32).view(torch.float32),
                     (kmin & 0xFFFFFFFF).to(torch.int32)))
    lo, hi, wv, eid = (torch.cat(parts) for parts in zip(*outs))
    count = lo.numel()
    plo, phi, pw, pe = _empty_pool(cap, L.device)
    n = min(count, cap)
    plo[:n], phi[:n], pw[:n], pe[:n] = lo[:n], hi[:n], wv[:n], eid[:n]
    count_t = torch.tensor(count, dtype=torch.int32, device=L.device)
    return plo, phi, pw, pe, count_t, count_t > cap


def _kernel():
    lib = _build.load("extract")
    fn = lib.gseg_boundary_extract
    if not getattr(lib, "gseg_bound", False):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
        lib.gseg_bound = True
    return fn


def boundary_extract(L, weights, cap: int):
    """Compacted live boundary-edge candidates from dense planes.

    L: (H, W) int32 labels. weights: (4, H, W) float32 (+inf invalid).
    Returns (lo, hi, w, eid, count, overflow): (cap,) pools, a 0-d int32
    exact entry count and a 0-d bool overflow."""
    h, w = L.shape
    if weights.shape != (4, h, w):
        raise ValueError(f"boundary_extract: weights {tuple(weights.shape)} "
                         f"do not match labels {(h, w)}")
    if _build.on_cpu(L, weights):
        return boundary_extract_plain(L, weights, cap)
    if L.dtype != torch.int32 or weights.dtype != torch.float32 \
            or not (L.is_contiguous() and weights.is_contiguous()):
        raise ValueError("boundary_extract: contiguous int32 labels and "
                         "float32 weights expected")
    # one allocation: the four pools, then the count and overflow words,
    # all written by the kernel's C entry.
    buf = torch.empty(4 * cap + 2, dtype=torch.int32, device=L.device)
    lo, hi, wv, eid = (buf[i * cap:(i + 1) * cap] for i in range(4))
    dev = L.get_device()
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = _kernel()(L.data_ptr(), weights.data_ptr(), h, w, cap,
                        lo.data_ptr(), hi.data_ptr(), wv.data_ptr(),
                        eid.data_ptr(), buf[4 * cap:].data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gseg_boundary_extract")
    _build.count(_WRAPPER)
    overflow = buf[4 * cap + 1:].view(torch.uint8)[0].view(torch.bool)
    return lo, hi, wv.view(torch.float32), eid, buf[4 * cap], overflow


# the launch count lives on the wrapper object (bound here, so a caller that
# re-binds the module name still counts on the original).
_WRAPPER = boundary_extract
_WRAPPER.launches = 0

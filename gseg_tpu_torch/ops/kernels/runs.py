"""Row-run extraction for the `runs` peel's component sizes.

Port of `gseg_tpu/ops/pallas/extract.py:run_extract`, with:

  - the kernel: `csrc/runs.cu` (one block per image row: a max-scan of
    head positions gives each run's length at its tail, a block claims the
    slots of a tile's pairs with one atomic and writes them coalesced; the
    same C entry then writes the sentinels past the count);
  - the plain PyTorch version: run tails from a row-wise comparison, run
    heads from a row-wise `cummax` of head positions.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel. `run_extract.launches` counts launches.

Every maximal run of equal labels within one row of L yields one pair
(label, run length). Pairs fill slots [0, count) in no particular order
(the plain version: row-major order of the run tails); slots past them
hold label INT32_MAX and length 0. `count` is exact (the reference's is an
upper bound at its output-window granularity); `overflow` is count > cap,
and pairs past the capacity are dropped, so the caller must then treat the
pool as invalid. Summing the lengths by label gives exact component pixel
counts.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .. import grid_graph as gg
from . import _build

INT32_MAX = gg.INT32_MAX


def _empty_pool(cap, device):
    return (torch.full((cap,), INT32_MAX, dtype=torch.int32, device=device),
            torch.zeros((cap,), dtype=torch.int32, device=device))


def run_extract_plain(L, cap: int):
    """Returns (lab, cnt, count, overflow); see the module note."""
    h, w = L.shape
    col = torch.arange(w, device=L.device).expand(h, w)
    head = torch.ones((h, w), dtype=torch.bool, device=L.device)
    head[:, 1:] = L[:, 1:] != L[:, :-1]
    tail = torch.ones_like(head)
    tail[:, :-1] = head[:, 1:]
    start = torch.cummax(torch.where(head, col, -1), dim=1).values
    lab = L[tail]
    cnt = (col - start + 1)[tail].to(torch.int32)
    count = lab.numel()
    plab, pcnt = _empty_pool(cap, L.device)
    n = min(count, cap)
    plab[:n], pcnt[:n] = lab[:n], cnt[:n]
    count_t = torch.tensor(count, dtype=torch.int32, device=L.device)
    return plab, pcnt, count_t, count_t > cap


def _kernel():
    lib = _build.load("runs")
    fn = lib.gseg_run_extract
    if not getattr(lib, "gseg_bound", False):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        lib.gseg_bound = True
    return fn


def run_extract(L, cap: int):
    """Compacted (label, run length) pairs of the row runs of L.

    L: (H, W) int32 labels. Returns (lab, cnt, count, overflow): (cap,)
    int32 pools, a 0-d int32 exact pair count and a 0-d bool overflow."""
    if L.dtype != torch.int32 or L.dim() != 2:
        raise ValueError(f"run_extract: expected an (H, W) int32 plane, got "
                         f"{L.dtype} {tuple(L.shape)}")
    if _build.on_cpu(L):
        return run_extract_plain(L, cap)
    if not L.is_contiguous():
        raise ValueError("run_extract: the kernel takes a contiguous plane")
    h, w = L.shape
    # one allocation: the two pools, then the count and overflow words,
    # all written by the kernel's C entry.
    buf = torch.empty(2 * cap + 2, dtype=torch.int32, device=L.device)
    dev = L.get_device()
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = _kernel()(L.data_ptr(), h, w, cap, buf.data_ptr(),
                        buf[cap:].data_ptr(), buf[2 * cap:].data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gseg_run_extract")
    _build.count(_WRAPPER)
    overflow = buf[2 * cap + 1:].view(torch.uint8)[0].view(torch.bool)
    return buf[:cap], buf[cap:2 * cap], buf[2 * cap], overflow


# the launch count lives on the wrapper object (bound here, so a caller that
# re-binds the module name still counts on the original).
_WRAPPER = run_extract
_WRAPPER.launches = 0

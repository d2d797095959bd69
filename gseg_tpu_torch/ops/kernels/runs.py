"""Row-run extraction for the `runs` peel's component sizes.

Port of `gseg_tpu/ops/pallas/extract.py:run_extract`, with:

  - the kernel: `csrc/runs.cu` (run tails walk to their heads and claim
    output slots with one atomic counter);
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
    fn = _build.load("runs").gseg_run_extract
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
    lab, cnt = _empty_pool(cap, L.device)
    count = torch.zeros((), dtype=torch.int32, device=L.device)
    fn = _kernel()
    with torch.cuda.device(L.device):
        err = fn(L.data_ptr(), h, w, cap, lab.data_ptr(), cnt.data_ptr(),
                 count.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "gseg_run_extract")
    _WRAPPER.launches += 1
    return lab, cnt, count, count > cap


# the launch count lives on the wrapper object (bound here, so a caller that
# re-binds the module name still counts on the original).
_WRAPPER = run_extract
_WRAPPER.launches = 0

"""The join of the chunk fronts in the chunked pair dedup.

`models.turbo._chunked_pair_extract` sorts n = nch * chunk slots in nch
chunks and moves each chunk's counts[c] pair heads to its front (perm: the
sorts' order within each chunk). This lays the fronts one after another
into pair_cap output slots, with:

  - the kernel: `csrc/pairjoin.cu` (one launch over the output slots; each
    block scans counts into shared memory, each slot finds its chunk by
    binary search and gathers its four words; no host read);
  - the plain PyTorch version: the same closed form, the chunk of each
    slot by `torch.searchsorted` over the clamped offsets.

Both are byte-equal, in every slot (the masked ones included) and in the
overflow flag, to the output-space scan the reference joins with
(gseg_tpu/models/turbo.py `_chunked_pair_extract`: a scatter of each
chunk's offset, a running maximum, the gathers). The kernel's offsets live
in 32 KB of shared memory: it takes at most MAX_CHUNKS = 8192 chunks (at
the dedup's 131072-slot chunks, 2^30 slots: 4 V up to V = 2^28 pixels),
and fewer than 2^31 slots. The wrapper raises beyond either, on every
device.

The arguments are checked on every device; the wrapper takes the plain
version only for CPU tensors and launches the kernel for CUDA tensors.
`pair_join.launches` counts the kernel's launches, one a call (on the
tracing's counters too: `pair_join.launches`).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ...utils import timing
from . import _build

MAX_CHUNKS = 8192   # csrc/pairjoin.cu: offsets in 32 KB of shared memory
INT32_MAX = 2**31 - 1


def _check(counts, perm, lo, hi, w4, eid4, pair_cap):
    ins = (counts, perm, lo, hi, w4, eid4)
    want = (torch.int64, torch.int64, torch.int32, torch.int32,
            torch.float32, torch.int32)
    if any(x.dtype != d for x, d in zip(ins, want)):
        raise ValueError("pair_join: expected int64 counts and perm, int32 "
                         "lo, hi, eid4 and float32 w4, got "
                         f"{[x.dtype for x in ins]}")
    if perm.dim() != 2 or counts.shape != perm.shape[:1] or any(
            x.shape != (perm.numel(),) for x in (lo, hi, w4, eid4)):
        raise ValueError("pair_join: expected counts (nch,), perm (nch, "
                         "chunk) and lo, hi, w4, eid4 (nch * chunk,), got "
                         f"{[tuple(x.shape) for x in ins]}")
    nch, chunk = perm.shape
    if not 1 <= nch <= MAX_CHUNKS or chunk < 1:
        raise ValueError(f"pair_join: 1 to {MAX_CHUNKS} chunks of at least "
                         f"one slot, got {nch} of {chunk}")
    if perm.numel() > INT32_MAX or not 1 <= pair_cap <= INT32_MAX:
        raise ValueError(f"pair_join: {perm.numel()} slots and a pair cap "
                         f"of {pair_cap}: both must lie in [1, 2^31)")


def pair_join_plain(counts, perm, lo, hi, w4, eid4, pair_cap: int):
    """The join on any device, arguments as `pair_join`'s."""
    nch, chunk = perm.shape
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    j = torch.arange(pair_cap, device=perm.device)
    chunk_of = torch.searchsorted(offsets.clamp(max=pair_cap - 1), j,
                                  right=True) - 1
    src = (chunk_of * chunk + j - offsets[chunk_of]).clamp(0, nch * chunk - 1)
    g = src // chunk * chunk + perm.reshape(-1)[src]
    return j < total, lo[g], hi[g], w4[g], eid4[g], total > pair_cap


def _kernel():
    lib = _build.load("pairjoin")
    fn = lib.gseg_pair_join
    if not getattr(lib, "gseg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i, i, i] + [p] * 7
        fn.restype = ctypes.c_int
        lib.gseg_bound = True
    return fn


def pair_join(counts, perm, lo, hi, w4, eid4, pair_cap: int):
    """Join the chunk fronts. counts (nch,) int64: each chunk's heads;
    perm (nch, chunk) int64: the sorted order within each chunk, heads
    first; lo, hi, eid4 (nch * chunk,) int32 and w4 float32: the slots.
    Returns new tensors (mask, lo, hi, w, eid) of size pair_cap and a 0-d
    bool overflow (total heads > pair_cap; the output is then invalid)."""
    _check(counts, perm, lo, hi, w4, eid4, pair_cap)
    ins = (counts, perm, lo, hi, w4, eid4)
    if _build.on_cpu(*ins):
        return pair_join_plain(counts, perm, lo, hi, w4, eid4, pair_cap)
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("pair_join: the kernel takes contiguous tensors")
    dev = perm.device
    out = (torch.empty(pair_cap, dtype=torch.bool, device=dev),
           *(torch.empty(pair_cap, dtype=x.dtype, device=dev)
             for x in (lo, hi, w4, eid4)),
           torch.empty((), dtype=torch.bool, device=dev))
    nch, chunk = perm.shape
    index = dev.index
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = _kernel()(*(x.data_ptr() for x in ins), nch, chunk, pair_cap,
                        *(o.data_ptr() for o in out),
                        torch.cuda.current_stream(index).cuda_stream)
    _build.check(err, "gseg_pair_join")
    _build.count(_WRAPPER)
    timing.count("pair_join.launches")
    return out


# the launch count lives on the wrapper object (bound here, so a caller that
# re-binds the module name still counts on the original).
_WRAPPER = pair_join
_WRAPPER.launches = 0

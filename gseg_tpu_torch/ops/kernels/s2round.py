"""One compact round of stage 2 over its label slots, with no sort.

The round of `models.turbo._s2_round` (the ops `_s2_round_ops` run; they
stay the oracle), with:

  - the kernel: `csrc/s2round.cu` (one C entry queues the round's
    launches on the current stream: per-slot minimum edges by 64-bit
    atomics, head ranks by a scan, hooks, hook chains by bounded jumps,
    canonical roots, sizes and Int by atomics, the relabel; no host read);
  - the plain PyTorch version: the same steps on the same slot arrays,
    with `scatter_reduce` over packed int64 keys in place of the atomics.

Both are byte-equal to `_s2_round_ops`, flags included. The state has n
label slots (SZf, IDf: the root list's positions in root space, labels
when V-indexed) and a pool of e entries (esrc, edst, ew, eeid); see the
source's note for the round itself. Weights and Int must be non-negative
(their bits order like their values).

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel. `s2_round.launches` counts the rounds the kernel
ran, one a call.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .. import grid_graph as gg
from . import _build

INT32_MAX = gg.INT32_MAX
INT64_MAX = 2**63 - 1
FLAG_COMP_OVERFLOW = 4   # models/turbo.py (which imports this module)
BLOCK = 1024             # csrc/s2round.cu: slots a block of the head ranks
HOPS_LOG2 = 5            # csrc/s2round.cu: 32 hops a jump launch


def scratch_bytes(n: int) -> int:
    """Bytes of the kernel's slot arrays at n slots: the 8-byte minimum
    edge and six int32 arrays a slot, two int32 words a block of BLOCK
    slots."""
    return 32 * n + 8 * -(-n // BLOCK)


def jump_launches(head_cap: int, n: int) -> int:
    """The kernel's jump launches (32 hops each): enough for 2^s hops, s
    the ops' pointer-doubling steps at a head cap of min(head_cap, n)."""
    steps = max(min(head_cap, n).bit_length() + 1, 4)
    return -(-steps // HOPS_LOG2)


def _scatter_min(n, idx, vals, fill):
    """Per slot the least of vals at idx (idx == n dropped), else fill."""
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx, vals, "amin")[:n]


def s2_round_plain(esrc, edst, ew, eeid, SZf, IDf, fin, flags, *,
                   head_cap: int, k, min_size, is_felz: bool, tau=None,
                   canonical: bool = True):
    """The wrapper's round on any device, arguments as `s2_round`'s.
    Returns (esrc, edst, SZf, IDf, fin, merged, flags), new tensors."""
    dev = esrc.device
    n = SZf.numel()
    slots = torch.arange(n, dtype=torch.int64, device=dev)
    live = (esrc != edst) & torch.isfinite(ew)
    if tau is not None:
        live &= ew <= tau
    # per slot the least (w, eeid), then the lowest position holding it
    key = ((ew.view(torch.int32).to(torch.int64) << 32)
           + eeid.to(torch.int64) + 2**31)
    src = torch.where(live, esrc.to(torch.int64), n)
    best = _scatter_min(n, src, key, INT64_MAX)
    won = live & (key == torch.cat([best, best.new_full((1,), -1)])[src])
    pos = torch.arange(esrc.numel(), dtype=torch.int64, device=dev)
    bpos = _scatter_min(n, torch.where(won, src, n), pos, INT64_MAX)
    # heads in slot order, capped at head_cap
    head = best != INT64_MAX
    rank = torch.cumsum(head, 0) - head.to(torch.int64)
    capped = head & (rank < head_cap)
    hw = (best >> 32).to(torch.int32).view(torch.float32)
    dst = (edst[bpos.clamp(max=esrc.numel() - 1)].to(torch.int64)
           if esrc.numel() else slots)
    dst = torch.where(capped, dst, slots)
    if is_felz:
        kf = (k if isinstance(k, torch.Tensor)
              else torch.tensor(k, dtype=torch.float32, device=dev))
        ls = (hw - IDf) * SZf.float()
        ld = (hw - IDf[dst]) * SZf[dst].float()
        ok = (ls <= kf) & (ld <= kf)
    else:
        ok = SZf < min_size
    hook = torch.where(capped, torch.where(ok, dst, slots), -1)
    # mutual pairs to the smaller label; next: the target where a head
    hook_at = hook[hook.clamp(min=0)]
    mutual = capped & (hook != slots) & (hook_at == slots) & (slots < hook)
    succ = torch.where(mutual, slots, hook)
    to_head = capped & (succ != slots) & (hook[succ.clamp(min=0)] >= 0)
    p = torch.where(capped, torch.where(to_head, succ, slots), -1)
    # the jump launches: each follows 32 hops, five squarings
    for _ in range(HOPS_LOG2 * jump_launches(head_cap, n)):
        p = torch.where(p >= 0, p[p.clamp(min=0)], p)
    if canonical:
        canon = _scatter_min(n, torch.where(capped, p, n), slots, INT32_MAX)
        r = torch.where(capped, canon[p.clamp(min=0)], slots)
    else:
        r = torch.where(capped, p, slots)
    changed = capped & (r != slots)
    tgt = torch.where(changed, r, n)
    SZf2 = torch.cat([SZf, SZf.new_zeros(1)]).scatter_reduce_(
        0, tgt, SZf, "sum")[:n]
    IDf2 = torch.cat([IDf, IDf.new_zeros(1)])
    IDf2.scatter_reduce_(0, tgt, IDf, "amax")
    used = capped & (succ != slots)
    IDf2 = IDf2.scatter_reduce_(0, torch.where(used, r, n), hw,
                                "amax")[:n]
    M = r.to(torch.int32)
    return (M[esrc.to(torch.int64)], M[edst.to(torch.int64)], SZf2, IDf2,
            M[fin.to(torch.int64)], changed.any(),
            flags | (head.sum() > head_cap).to(torch.int32)
            * FLAG_COMP_OVERFLOW)


def _kernel():
    lib = _build.load("s2round")
    fn = lib.gseg_s2_round
    if not getattr(lib, "gseg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, p, p, p, i, p, p, i, p, i, p]
                       + [p] * 7 + [ctypes.c_float, p, i, i, i, i, p, p])
        fn.restype = ctypes.c_int
        lib.gseg_bound = True
    return fn


def _f32(x, what, dev):
    if x.dtype != torch.float32 or x.numel() != 1 or x.device != dev:
        raise ValueError(f"s2_round: {what} must be a float32 scalar on "
                         f"{dev}, got {x.dtype} {tuple(x.shape)} {x.device}")
    return x.data_ptr()


def s2_round(esrc, edst, ew, eeid, SZf, IDf, fin, flags, *, head_cap: int,
             k, min_size, is_felz: bool, tau=None,
             canonical: bool = True):
    """One compact round. esrc, edst, eeid: (e,) int32; ew: (e,) float32;
    SZf (n,) int32, IDf (n,) float32; fin (c,) int32 labels in [0, n);
    flags: () int32. k: the felz threshold, a number; min_size: a
    min-size round's (a felz round ignores it: None will do); tau: the
    felz round's weight cap (float32 scalar tensor) or None. Returns new
    tensors (esrc, edst, SZf, IDf, fin, merged, flags), merged a 0-d
    bool."""
    ins = (esrc, edst, ew, eeid, SZf, IDf, fin, flags)
    want = (torch.int32, torch.int32, torch.float32, torch.int32,
            torch.int32, torch.float32, torch.int32, torch.int32)
    if any(x.dtype != d for x, d in zip(ins, want)) or flags.numel() != 1:
        raise ValueError("s2_round: expected int32 esrc, edst, eeid, SZf, "
                         "fin, flags and float32 ew, IDf, got "
                         f"{[x.dtype for x in ins]}")
    min_size = 0 if is_felz else int(min_size)   # felz rounds take none
    n, e = SZf.numel(), esrc.numel()
    if n < 1 or IDf.numel() != n or any(x.numel() != e
                                        for x in (edst, ew, eeid)):
        raise ValueError(f"s2_round: pool sizes {[x.numel() for x in ins]}")
    if _build.on_cpu(*ins):
        return s2_round_plain(esrc, edst, ew, eeid, SZf, IDf, fin, flags,
                              head_cap=head_cap, k=k, min_size=min_size,
                              is_felz=is_felz, tau=tau, canonical=canonical)
    dev = esrc.device
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("s2_round: the kernel takes contiguous tensors")
    out = (torch.empty_like(esrc), torch.empty_like(edst),
           torch.empty_like(SZf), torch.empty_like(IDf),
           torch.empty_like(fin),
           torch.empty((), dtype=torch.bool, device=dev),
           torch.empty((), dtype=torch.int32, device=dev))
    scratch = torch.empty(-(-scratch_bytes(n) // 8), dtype=torch.int64,
                          device=dev)
    tau_ptr = None if tau is None else _f32(tau, "tau", dev)
    index = dev.index
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = _kernel()(
            esrc.data_ptr(), edst.data_ptr(), ew.data_ptr(), eeid.data_ptr(),
            e, SZf.data_ptr(), IDf.data_ptr(), n, fin.data_ptr(),
            fin.numel(), flags.data_ptr(), *(o.data_ptr() for o in out),
            float(k), tau_ptr, int(is_felz), min_size,
            int(canonical), int(min(head_cap, INT32_MAX)),
            scratch.data_ptr(),
            torch.cuda.current_stream(index).cuda_stream)
    _build.check(err, "gseg_s2_round")
    _build.count(_WRAPPER)
    return out


# the launch count lives on the wrapper object (bound here, so a caller that
# re-binds the module name still counts on the original).
_WRAPPER = s2_round
_WRAPPER.launches = 0

"""Step fixpoints of the turbo path's stage G and final map.

Port of the speed-path entry points of `gseg_tpu/ops/pallas/gossip.py`
(`compmin_gossip`, `label_flood`, `value_flood`, all with
`closures=False`, driven as `_step_fixpoint` drives them), with:

  - the kernel: `csrc/gossip.cu`, one T-step Jacobi pass over 2D tiles
    with a T-pixel halo, one template per variant (see the note there);
  - the plain PyTorch version of each fixpoint, in the XLA-sweep form of
    `gseg_tpu/models/turbo.py` (`_compmin_gossip`, `_label_gossip_nd`,
    `_value_flood`): one 8-direction step per sweep until a sweep changes
    nothing.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel (and raises if it cannot). Each wrapper counts its
kernel launches in `<wrapper>.launches`. Both forms reach the same unique
fixpoint (semilattice joins per connected region), so their outputs are
bit-equal; `unconverged` is True when the sweep or pass cap ended the loop
with the last sweep/pass still changing something.
"""

from __future__ import annotations

import ctypes

import torch

from .. import grid_graph as gg
from . import _build

INT32_MAX = gg.INT32_MAX


def pack_allow_bits(allow8_list) -> torch.Tensor:
    """(8 (H, W) bool planes, DIRS8 order) -> packed int32 bits."""
    bits = torch.zeros(allow8_list[0].shape, dtype=torch.int32,
                       device=allow8_list[0].device)
    for d in range(8):
        bits = bits | (allow8_list[d].to(torch.int32) << d)
    return bits


# ---------------------------------------------------------------------------
# plain versions (XLA-sweep form)
# ---------------------------------------------------------------------------


def _shifts8(x, fill):
    return [gg.shift_plane(x, dy, dx, fill) for dy, dx in gg.DIRS8]


def compmin_gossip_plain(L, bw, be, sz, max_sweeps):
    """Lexmin (bw, be) + max sz among same-L 8-neighbors, to the fixpoint.
    Returns (bw, be, sz, unconverged)."""
    nL = _shifts8(L, -1)
    same = [nL[d] == L for d in range(8)]
    changed, i = True, 0
    while changed and i < max_sweeps:
        nbw = _shifts8(bw, torch.inf)
        nbe = _shifts8(be, INT32_MAX)
        nsz = _shifts8(sz, 0)
        bw0, be0, sz0 = bw, be, sz
        for d in range(8):
            take = same[d] & ((nbw[d] < bw) | ((nbw[d] == bw) & (nbe[d] < be)))
            bw = torch.where(take, nbw[d], bw)
            be = torch.where(take, nbe[d], be)
            sz = torch.where(same[d] & (nsz[d] > sz), nsz[d], sz)
        changed = bool(((bw0 != bw) | (be0 != be) | (sz0 != sz)).any())
        i += 1
    return bw, be, sz, changed


def label_flood_plain(allow_bits, Lc, idf, max_sweeps):
    """Dist-free min-label flood over the packed allow adjacency, Int
    riding as a max. Returns (Lc, idf, unconverged)."""
    allow = [((allow_bits >> d) & 1) > 0 for d in range(8)]
    changed, i = True, 0
    while changed and i < max_sweeps:
        nL = _shifts8(Lc, INT32_MAX)
        nid = _shifts8(idf, 0.0)
        L0, id0 = Lc, idf
        for d in range(8):
            Lc = torch.where(allow[d] & (nL[d] < Lc), nL[d], Lc)
            idf = torch.where(allow[d] & (nid[d] > idf), nid[d], idf)
        changed = bool(((L0 != Lc) | (id0 != idf)).any())
        i += 1
    return Lc, idf, changed


def value_flood_plain(L, val, max_sweeps):
    """Min-value broadcast within same-L regions. Returns (val,
    unconverged)."""
    nL = _shifts8(L, -1)
    same = [nL[d] == L for d in range(8)]
    changed, i = True, 0
    while changed and i < max_sweeps:
        nv = _shifts8(val, INT32_MAX)
        v0 = val
        for d in range(8):
            val = torch.where(same[d] & (nv[d] < val), nv[d], val)
        changed = bool((v0 != val).any())
        i += 1
    return val, changed


# ---------------------------------------------------------------------------
# kernel passes
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {
    "compmin": ("gseg_compmin_pass", [_P] * 7 + [_I, _I, _P, _P]),
    "labelnd": ("gseg_labelnd_pass", [_P] * 5 + [_I, _I, _P, _P]),
    "value": ("gseg_value_pass", [_P] * 3 + [_I, _I, _P, _P]),
}


def _lib():
    lib = _build.load("gossip")
    for fname, argtypes in _ENTRY.values():
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gseg_gossip_steps.argtypes = []
    lib.gseg_gossip_steps.restype = ctypes.c_int
    return lib


def _check_fields(ro, fields):
    h, w = ro.shape
    for x in (ro, *fields):
        if x.shape != (h, w) or not x.is_contiguous():
            raise ValueError(f"gossip kernel: expected contiguous {(h, w)} "
                             f"planes, got {tuple(x.shape)}")
    if ro.dtype != torch.int32:
        raise ValueError("gossip kernel: the read-only plane must be int32")


def _run_fixpoint(variant, ro, fields, max_sweeps):
    """Jacobi passes (double-buffered) until one changes nothing or the
    pass cap ceil(max_sweeps / T) is reached. Returns (fields,
    unconverged)."""
    _check_fields(ro, fields)
    lib = _lib()
    fn = getattr(lib, _ENTRY[variant][0])
    max_passes = -(-max_sweeps // lib.gseg_gossip_steps())
    h, w = ro.shape
    # the first pass reads the caller's tensors, later ones ping-pong
    # between two scratch sets, so the inputs are never written.
    src = list(fields)
    bufs = [[torch.empty_like(x) for x in fields] for _ in range(2)]
    changed = torch.zeros(1, dtype=torch.int32, device=ro.device)
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream().cuda_stream
        for p in range(max_passes):
            dst = bufs[p % 2]
            changed.zero_()
            err = fn(ro.data_ptr(), *[x.data_ptr() for x in src],
                     *[x.data_ptr() for x in dst], h, w,
                     changed.data_ptr(), stream)
            _build.check(err, f"gseg_{variant}_pass")
            _WRAPPERS[variant].launches += 1
            src = dst
            if int(changed.item()) == 0:
                return src, False
    return src, True


def compmin_gossip(L, bw, be, sz, max_sweeps, idle=False):
    """Returns (bw, be, sz, unconverged).

    idle: True when (bw, be, sz) is the fixpoint by construction (round 1:
    an all-singleton label map has no same-label edges); the inputs come
    back unchanged and nothing runs."""
    if idle:
        return bw, be, sz, False
    if _build.on_cpu(L, bw, be, sz):
        return compmin_gossip_plain(L, bw, be, sz, max_sweeps)
    if bw.dtype != torch.float32 or be.dtype != torch.int32 \
            or sz.dtype != torch.int32:
        raise ValueError("compmin_gossip: bw float32, be/sz int32 expected")
    (bw, be, sz), unconv = _run_fixpoint("compmin", L, [bw, be, sz],
                                         max_sweeps)
    return bw, be, sz, unconv


def label_flood(allow_bits, Lc, idf, max_sweeps):
    """Dist-free label flood. Returns (Lc, idf, unconverged)."""
    if _build.on_cpu(allow_bits, Lc, idf):
        return label_flood_plain(allow_bits, Lc, idf, max_sweeps)
    if Lc.dtype != torch.int32 or idf.dtype != torch.float32:
        raise ValueError("label_flood: Lc int32, idf float32 expected")
    (Lc, idf), unconv = _run_fixpoint("labelnd", allow_bits, [Lc, idf],
                                      max_sweeps)
    return Lc, idf, unconv


def value_flood(L, val, max_sweeps):
    """Min-value broadcast within same-L regions. Returns (val,
    unconverged)."""
    if _build.on_cpu(L, val):
        return value_flood_plain(L, val, max_sweeps)
    if val.dtype != torch.int32:
        raise ValueError("value_flood: val int32 expected")
    (val,), unconv = _run_fixpoint("value", L, [val], max_sweeps)
    return val, unconv


# Launch counts live on the wrapper objects themselves (bound here, so a
# caller that re-binds the module names still counts on the originals).
_WRAPPERS = {"compmin": compmin_gossip, "labelnd": label_flood,
             "value": value_flood}
for _fn in _WRAPPERS.values():
    _fn.launches = 0

"""Step fixpoints of the turbo path's stage G and final map.

Port of the speed-path entry points of `gseg_tpu/ops/pallas/gossip.py`
(`compmin_gossip`, `label_gossip`, `label_flood`, `value_flood` and
`subtree_sums`, step-only (`closures=False`), driven as `_step_fixpoint`
drives them), with:

  - the kernel: `csrc/gossip.cu`, one T-step Jacobi pass over 2D tiles
    with a T-pixel halo, one template per variant (see the note there);
  - the plain PyTorch version of each fixpoint, in the XLA-sweep form of
    `gseg_tpu/models/turbo.py` (`_compmin_gossip`, `_label_gossip`,
    `_label_gossip_nd`, `_value_flood`, the sweep of `_subtree_sizes`):
    one 8-direction step per sweep until a sweep changes nothing.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel (and raises if it cannot). Each wrapper counts its
kernel launches in `<wrapper>.launches`. Both forms reach the same unique
fixpoint (semilattice joins per connected region; for the subtree sums an
affine map with a nilpotent part), so their outputs are bit-equal;
`unconverged` is True when the sweep or pass cap ended the loop with the
last sweep/pass still changing something.

Wide images (w >= PAD_MIN_WIDTH) take the reference's padded route: the
fields are padded once on entry (`kernels.pad.fast_pad_fields`), the
passes run on the padded planes as one (hp + 2T, wp) image, and the
read-write fields are cut back once on exit (`fast_unpad_fields`). It is
exact because every fill is inert: a -1 label equals no real label, allow
bits of 0 join nothing, a pdir of 8 makes no child, and each read-write
fill is the identity of its join (so a pad pixel offers nothing and, its
own adjacency being empty, never changes; subsum pad pixels have no
parent and feed no one).
"""

from __future__ import annotations

import ctypes

import torch

from .. import grid_graph as gg
from . import _build
from . import pad as kp

INT32_MAX = gg.INT32_MAX
BIGDIST = 1 << 30     # dist of a pixel that no seed has reached
_REV = [4, 5, 6, 7, 0, 1, 2, 3]   # DIRS8 index of the reverse direction
PAD_MIN_WIDTH = 2560  # the reference's padded-route gate (_fastpad_on)
_TILE = 32            # interior side of a block in csrc/gossip.cu
_PAD_LANES = 128      # padded width multiple


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


def label_gossip_plain(allow_bits, Lc, idf, dist, max_sweeps):
    """Min-label flood over the packed allow adjacency with the BFS dist
    riding along (adopting a smaller label takes the neighbour's dist + 1,
    an equal label relaxes it) and Int riding as a max. Returns (Lc, idf,
    dist, unconverged)."""
    allow = [((allow_bits >> d) & 1) > 0 for d in range(8)]
    changed, i = True, 0
    while changed and i < max_sweeps:
        nL = _shifts8(Lc, INT32_MAX)
        nid = _shifts8(idf, 0.0)
        nds = _shifts8(dist, BIGDIST)
        L0, id0, d0 = Lc, idf, dist
        for d in range(8):
            cand = torch.where(nds[d] >= BIGDIST, BIGDIST, nds[d] + 1)
            adopt = allow[d] & (nL[d] < Lc)
            relax = allow[d] & (nL[d] == Lc) & (cand < dist)
            dist = torch.where(adopt | relax, cand, dist)
            Lc = torch.where(adopt, nL[d], Lc)
            idf = torch.where(allow[d] & (nid[d] > idf), nid[d], idf)
        changed = bool(((L0 != Lc) | (id0 != idf) | (d0 != dist)).any())
        i += 1
    return Lc, idf, dist, changed


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


def subtree_sums_plain(pdir, s, max_sweeps):
    """s <- 1 + sum of s over the children (neighbours whose parent
    direction points back), to the fixpoint. Returns (s, unconverged)."""
    npd = _shifts8(pdir, 8)
    child = [npd[d] == _REV[d] for d in range(8)]
    changed, i = True, 0
    while changed and i < max_sweeps:
        ns = _shifts8(s, 0)
        total = torch.ones_like(s)
        for d in range(8):
            total = total + torch.where(child[d], ns[d], 0)
        changed = bool((total != s).any())
        s = total
        i += 1
    return s, changed


# ---------------------------------------------------------------------------
# kernel passes
# ---------------------------------------------------------------------------

# variant -> (C entry point, fill of the read-only plane, fills of the
# read-write fields); the fills pad the fields on the wide-image route.
_VARIANTS = {
    "compmin": ("gseg_compmin_pass", -1, (torch.inf, INT32_MAX, 0)),
    "labeldist": ("gseg_labeldist_pass", 0, (INT32_MAX, 0.0, BIGDIST)),
    "labelnd": ("gseg_labelnd_pass", 0, (INT32_MAX, 0.0)),
    "value": ("gseg_value_pass", -1, (INT32_MAX,)),
    "subsum": ("gseg_subsum_pass", 8, (0,)),
}


def _lib():
    lib = _build.load("gossip")
    for fname, _, fills in _VARIANTS.values():
        fn = getattr(lib, fname)
        fn.argtypes = ([ctypes.c_void_p] * (1 + 2 * len(fills))
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.gseg_gossip_steps.argtypes = []
    lib.gseg_gossip_steps.restype = ctypes.c_int
    return lib


def _check_fields(variant, ro, fields):
    """Shapes and types of a variant's planes; checked on every device, so
    the CPU tests catch what the kernel would refuse. A read-write field is
    float32 where its fill is a float, else int32."""
    h, w = ro.shape
    want = [torch.float32 if isinstance(f, float) else torch.int32
            for f in _VARIANTS[variant][2]]
    if len(fields) != len(want) or ro.dtype != torch.int32 \
            or [x.dtype for x in fields] != want \
            or any(x.shape != (h, w) for x in fields):
        raise ValueError(
            f"{variant} fixpoint: expected an int32 read-only plane and "
            f"{[str(t) for t in want]} fields of its shape {(h, w)}; got "
            f"{ro.dtype} and {[(str(x.dtype), tuple(x.shape)) for x in fields]}")


def _fixpoint(variant, plain, ro, fields, max_sweeps):
    """The plain version for CPU tensors, the kernel passes for CUDA
    tensors. Returns (*fields, unconverged)."""
    _check_fields(variant, ro, fields)
    if _build.on_cpu(ro, *fields):
        return plain(ro, *fields, max_sweeps)
    out, unconv = _run_fixpoint(variant, ro, fields, max_sweeps)
    return (*out, unconv)


def _run_fixpoint(variant, ro, fields, max_sweeps):
    """Jacobi passes (double-buffered) until one changes nothing or the
    pass cap ceil(max_sweeps / T) is reached; wide images on padded planes
    (module note). Returns (fields, unconverged)."""
    if not all(x.is_contiguous() for x in (ro, *fields)):
        raise ValueError(f"{variant} fixpoint: the kernel takes contiguous "
                         "planes")
    lib = _lib()
    entry, ro_fill, fills = _VARIANTS[variant]
    fn = getattr(lib, entry)
    t = lib.gseg_gossip_steps()
    max_passes = -(-max_sweeps // t)
    h0, w0 = ro.shape
    padded = w0 >= PAD_MIN_WIDTH
    if padded:
        hp = -(-h0 // _TILE) * _TILE
        wp = -(-w0 // _PAD_LANES) * _PAD_LANES
        ro, *fields = kp.fast_pad_fields(
            [(ro, ro_fill), *zip(fields, fills)], t, hp, wp)
    fields, unconv = _passes(variant, fn, ro, fields, max_passes)
    if padded:
        fields = kp.fast_unpad_fields(fields, t, h0, w0)
    return fields, unconv


def _passes(variant, fn, ro, fields, max_passes):
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
    return _fixpoint("compmin", compmin_gossip_plain, L, [bw, be, sz],
                     max_sweeps)


def label_gossip(allow_bits, Lc, idf, dist, max_sweeps):
    """Label flood with the BFS dist riding along. Returns (Lc, idf, dist,
    unconverged)."""
    return _fixpoint("labeldist", label_gossip_plain, allow_bits,
                     [Lc, idf, dist], max_sweeps)


def label_flood(allow_bits, Lc, idf, max_sweeps):
    """Dist-free label flood. Returns (Lc, idf, unconverged)."""
    return _fixpoint("labelnd", label_flood_plain, allow_bits, [Lc, idf],
                     max_sweeps)


def value_flood(L, val, max_sweeps):
    """Min-value broadcast within same-L regions. Returns (val,
    unconverged)."""
    return _fixpoint("value", value_flood_plain, L, [val], max_sweeps)


def subtree_sums(pdir, s, max_sweeps):
    """Subtree sums over the parent tree given by pdir (DIRS8 index of the
    parent, 8 = none). Returns (s, unconverged)."""
    return _fixpoint("subsum", subtree_sums_plain, pdir, [s], max_sweeps)


# Launch counts live on the wrapper objects themselves (bound here, so a
# caller that re-binds the module names still counts on the originals).
_WRAPPERS = {"compmin": compmin_gossip, "labeldist": label_gossip,
             "labelnd": label_flood, "value": value_flood,
             "subsum": subtree_sums}
for _fn in _WRAPPERS.values():
    _fn.launches = 0

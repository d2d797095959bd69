"""Step and hybrid fixpoints of the turbo path's stage G and final map.

Port of the entry points of `gseg_tpu/ops/pallas/gossip.py`
(`compmin_gossip`, `label_gossip`, `label_flood`, `value_flood` and
`subtree_sums`, driven as `_step_fixpoint` and `_hybrid_fixpoint` drive
them), with:

  - the step kernel: `csrc/gossip.cu`, one T-step Jacobi pass over 2D
    tiles with a T-pixel halo, one template per variant (see the note
    there);
  - the closure kernel: `csrc/closure.cu`, one bidirectional segmented
    interval closure along every full row or every full column, for the
    compmin, labelnd and value variants (see the note there);
  - the plain PyTorch version of each fixpoint, in the XLA-sweep form of
    `gseg_tpu/models/turbo.py` (`_compmin_gossip`, `_label_gossip`,
    `_label_gossip_nd`, `_value_flood`, the sweep of `_subtree_sizes`):
    one 8-direction step per sweep until a sweep changes nothing; and of
    each closure launch (`*_closure_plain`: the reference's log-step
    doubling with reach composition, `_seg_closure`).

A wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel (and raises if it cannot). Each wrapper counts its
kernel launches in `<wrapper>.launches` (the closure wrappers also per
axis, in `<wrapper>.axis_launches`). Both forms reach the same unique
fixpoint (semilattice joins per connected region; for the subtree sums an
affine map with a nilpotent part), so their outputs are bit-equal;
`unconverged` is True when the sweep or pass cap ended the loop with the
last sweep/pass still changing something.

`closures=True` (compmin, label flood, value flood; quality mode) takes
the reference's two-phase hybrid route on the card: up to
min(cap, WARM_PASSES) step passes, then, while unconverged, pairs of
(step pass + rows closure) and (step pass + columns closure), each pair
one pass against the same cap, until a pair changes nothing. The step
passes keep T = 8 (the reference's T_SCAN = 4 in phase 2 was a VMEM and
roll-cost choice on the TPU). Every step and closure only lowers mins and
raises maxes of a semilattice fixpoint whose solution is unique, and a
round in which nothing changed contains a full step, so the exit
certifies the same fixpoint as the step-only route: the results are
bit-equal to it and to the plain version. `HYBRID_LOG` records each
hybrid call's step passes and pairs on the card. `label_gossip` and
`subtree_sums` stay step-only, as in the reference.

Wide images (w >= PAD_MIN_WIDTH) take the reference's padded route: the
fields are padded once on entry (`kernels.pad.fast_pad_fields`), the
passes run on the padded planes as one (hp + 2T, wp) image, and the
read-write fields are cut back once on exit (`fast_unpad_fields`). It is
exact because every fill is inert: a -1 label equals no real label, allow
bits of 0 join nothing, a pdir of 8 makes no child, and each read-write
fill is the identity of its join (so a pad pixel offers nothing and, its
own adjacency being empty, never changes; subsum pad pixels have no
parent and feed no one). The closures run on the same padded planes.
"""

from __future__ import annotations

import collections
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
# Step passes before the closure route engages (the reference's
# WARM_PASSES, gossip.py:383); tests and chip_smoke.py set it to 0 to run
# the closures from the first pass.
WARM_PASSES = 64
# DIRS8 bits of the closure reach links (gseg_tpu/ops/pallas/gossip.py:
# 86-91): flow from the left, right, above, below.
_BIT_L, _BIT_R, _BIT_U, _BIT_D = 4, 0, 5, 1
# (variant, step passes, closure pairs) of the latest hybrid calls on the
# card; bounded, so a long-running caller does not grow it without end.
HYBRID_LOG: collections.deque[tuple[str, int, int]] = collections.deque(
    maxlen=4096)


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
# plain versions of one closure launch (the reference's doubling form)
# ---------------------------------------------------------------------------


def _shift_axis(x, s, axis, fill):
    """out[i] = x[i - s] along `axis` (1: rows, 0: columns), else fill."""
    return gg.shift_plane(x, -s if axis == 0 else 0, -s if axis == 1 else 0,
                          fill)


def _reach(ro, kind, axis):
    """(fwd, bwd) bool planes: True where a pixel takes the value of its
    predecessor / successor along `axis`. kind "label": same label, both
    ways; "allow": bits 4 / 0 (rows) or 5 / 1 (columns), none across the
    ends."""
    n = ro.shape[axis]
    if kind == "label":
        same = ro.narrow(axis, 1, n - 1) == ro.narrow(axis, 0, n - 1)
        fwd = torch.zeros(ro.shape, dtype=torch.bool, device=ro.device)
        bwd = torch.zeros_like(fwd)
        fwd.narrow(axis, 1, n - 1).copy_(same)
        bwd.narrow(axis, 0, n - 1).copy_(same)
        return fwd, bwd
    bf, bb = (_BIT_L, _BIT_R) if axis == 1 else (_BIT_U, _BIT_D)
    fwd = ((ro >> bf) & 1) > 0
    bwd = ((ro >> bb) & 1) > 0
    fwd.narrow(axis, 0, 1).fill_(False)
    bwd.narrow(axis, n - 1, 1).fill_(False)
    return fwd, bwd


def _seg_closure_plain(reach, join, fields, fills, axis):
    """Forward then backward segmented closure by log-step doubling: at
    distance s each pixel joins the pixel s back when the reach interval
    between them is unbroken, and the reach composes over 2s
    (`_seg_closure`, without the roll's wrap)."""
    n = fields[0].shape[axis]
    for sign, rch in ((1, reach[0]), (-1, reach[1])):
        s = 1
        while s < n:
            cands = [_shift_axis(f, sign * s, axis, fill)
                     for f, fill in zip(fields, fills)]
            fields = join(cands, fields, rch)
            rch = rch & _shift_axis(rch, sign * s, axis, False)
            s *= 2
    return fields


def _compmin_join(cands, fields, ok):
    (cw, ce, csz), (bw, be, sz) = cands, fields
    take = ok & ((cw < bw) | ((cw == bw) & (ce < be)))
    return [torch.where(take, cw, bw), torch.where(take, ce, be),
            torch.where(ok & (csz > sz), csz, sz)]


def _labelnd_join(cands, fields, ok):
    (cL, cid), (Lc, idf) = cands, fields
    return [torch.where(ok & (cL < Lc), cL, Lc),
            torch.where(ok & (cid > idf), cid, idf)]


def _value_join(cands, fields, ok):
    return [torch.where(ok & (cands[0] < fields[0]), cands[0], fields[0])]


def _closure_plain(kind, join, fills, ro, fields, axis):
    out = _seg_closure_plain(_reach(ro, kind, axis), join, fields, fills,
                             axis)
    changed = any(bool((a != b).any()) for a, b in zip(out, fields))
    return (*out, changed)


def compmin_closure_plain(L, bw, be, sz, axis):
    """One closure launch: lexmin (bw, be) and max sz over each same-label
    run of every row (axis=1) or column (axis=0). Returns (bw, be, sz,
    changed)."""
    return _closure_plain("label", _compmin_join, (torch.inf, INT32_MAX, 0),
                          L, [bw, be, sz], axis)


def labelnd_closure_plain(allow_bits, Lc, idf, axis):
    """One closure launch: min Lc and max idf over each run of allow links
    of every row or column. Returns (Lc, idf, changed)."""
    return _closure_plain("allow", _labelnd_join, (INT32_MAX, 0.0),
                          allow_bits, [Lc, idf], axis)


def value_closure_plain(L, val, axis):
    """One closure launch: min val over each same-label run of every row or
    column. Returns (val, changed)."""
    return _closure_plain("label", _value_join, (INT32_MAX,), L, [val], axis)


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


# variant -> C entry point of its closure launch (csrc/closure.cu)
_CLOSURE_ENTRIES = {"compmin": "gseg_compmin_closure",
                    "labelnd": "gseg_labelnd_closure",
                    "value": "gseg_value_closure"}
_closure_max_width: dict[int, int] = {}


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


def _closure_lib():
    lib = _build.load("closure")
    for variant, fname in _CLOSURE_ENTRIES.items():
        fn = getattr(lib, fname)
        fn.argtypes = ([ctypes.c_void_p] * (1 + len(_VARIANTS[variant][2]))
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    lib.gseg_closure_max_width.argtypes = [ctypes.c_int]
    lib.gseg_closure_max_width.restype = ctypes.c_int
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


def _check_contiguous(variant, planes):
    if not all(x.is_contiguous() for x in planes):
        raise ValueError(f"{variant}: the kernel takes contiguous planes")


def _fixpoint(variant, plain, ro, fields, max_sweeps, closures=False):
    """The plain version for CPU tensors, the kernel passes for CUDA
    tensors (the hybrid route with closures). Returns (*fields,
    unconverged)."""
    _check_fields(variant, ro, fields)
    if _build.on_cpu(ro, *fields):
        return plain(ro, *fields, max_sweeps)
    out, unconv = _run_fixpoint(variant, ro, fields, max_sweeps, closures)
    return (*out, unconv)


def _run_fixpoint(variant, ro, fields, max_sweeps, closures):
    """Jacobi passes (double-buffered) until one changes nothing or the
    pass cap ceil(max_sweeps / T) is reached, the hybrid route with
    closures; wide images on padded planes (module note). Returns (fields,
    unconverged)."""
    _check_contiguous(f"{variant} fixpoint", (ro, *fields))
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
    fields, unconv = _passes(variant, fn, ro, fields, max_passes, closures)
    if padded:
        fields = kp.fast_unpad_fields(fields, t, h0, w0)
    return fields, unconv


def _passes(variant, fn, ro, fields, max_passes, closures):
    h, w = ro.shape
    # the first pass reads the caller's tensors, later ones ping-pong
    # between two scratch sets (the closures update a scratch set in
    # place), so the inputs are never written.
    src = list(fields)
    bufs = [[torch.empty_like(x) for x in fields] for _ in range(2)]
    changed = torch.zeros(1, dtype=torch.int32, device=ro.device)
    warm = min(max_passes, WARM_PASSES) if closures else max_passes
    clib = _closure_lib() if closures else None
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream().cuda_stream
        n = 0

        def step():
            nonlocal src, n
            dst = bufs[n % 2]
            err = fn(ro.data_ptr(), *[x.data_ptr() for x in src],
                     *[x.data_ptr() for x in dst], h, w,
                     changed.data_ptr(), stream)
            _build.check(err, f"gseg_{variant}_pass")
            _WRAPPERS[variant].launches += 1
            src = dst
            n += 1

        for _ in range(warm):
            changed.zero_()
            step()
            if int(changed.item()) == 0:
                if closures:
                    HYBRID_LOG.append((variant, n, 0))
                return src, False
        if not closures:
            return src, True
        # phase 2: each pair is one pass against the cap.
        pairs = 0
        while warm + pairs < max_passes:
            changed.zero_()
            for axis in (1, 0):
                step()
                _closure_launch(variant, clib, ro, src, axis, changed, stream)
            pairs += 1
            if int(changed.item()) == 0:
                HYBRID_LOG.append((variant, warm, pairs))
                return src, False
    HYBRID_LOG.append((variant, warm, pairs))
    return src, True


def _closure_launch(variant, lib, ro, fields, axis, changed, stream):
    """One closure launch on contiguous CUDA planes, updating `fields` in
    place and ORing `changed`."""
    h, w = ro.shape
    nrw = len(fields)
    if axis == 1:
        if nrw not in _closure_max_width:
            _closure_max_width[nrw] = lib.gseg_closure_max_width(nrw)
        if w > _closure_max_width[nrw]:
            raise ValueError(f"{variant} closure: rows of {w} pixels exceed "
                             f"the kernel's {_closure_max_width[nrw]}")
    entry = _CLOSURE_ENTRIES[variant]
    err = getattr(lib, entry)(ro.data_ptr(), *[x.data_ptr() for x in fields],
                              h, w, axis, changed.data_ptr(), stream)
    _build.check(err, entry)
    wrapper = _CLOSURE_WRAPPERS[variant]
    wrapper.launches += 1
    wrapper.axis_launches[axis] += 1


def _closure(variant, plain, ro, fields, axis):
    """One closure launch: the plain version for CPU tensors, the kernel
    (on copies of the fields) for CUDA tensors. Returns (*fields,
    changed)."""
    _check_fields(variant, ro, fields)
    if axis not in (0, 1):
        raise ValueError(f"{variant} closure: axis must be 0 or 1, got {axis}")
    if _build.on_cpu(ro, *fields):
        return plain(ro, *fields, axis)
    _check_contiguous(f"{variant} closure", (ro, *fields))
    out = [x.clone() for x in fields]
    changed = torch.zeros(1, dtype=torch.int32, device=ro.device)
    with torch.cuda.device(ro.device):
        _closure_launch(variant, _closure_lib(), ro, out, axis, changed,
                        torch.cuda.current_stream().cuda_stream)
    return (*out, bool(changed.item()))


def compmin_closure(L, bw, be, sz, axis):
    """One closure of (bw, be, sz) along every row (axis=1) or column
    (axis=0); see compmin_closure_plain. Returns (bw, be, sz, changed)."""
    return _closure("compmin", compmin_closure_plain, L, [bw, be, sz], axis)


def labelnd_closure(allow_bits, Lc, idf, axis):
    """One closure of (Lc, idf) over the allow links along every row or
    column. Returns (Lc, idf, changed)."""
    return _closure("labelnd", labelnd_closure_plain, allow_bits, [Lc, idf],
                    axis)


def value_closure(L, val, axis):
    """One closure of val along every row or column. Returns (val,
    changed)."""
    return _closure("value", value_closure_plain, L, [val], axis)


def compmin_gossip(L, bw, be, sz, max_sweeps, idle=False, closures=False):
    """Returns (bw, be, sz, unconverged).

    idle: True when (bw, be, sz) is the fixpoint by construction (round 1:
    an all-singleton label map has no same-label edges); the inputs come
    back unchanged and nothing runs. closures: the hybrid route on the
    card (module note)."""
    if idle:
        return bw, be, sz, False
    return _fixpoint("compmin", compmin_gossip_plain, L, [bw, be, sz],
                     max_sweeps, closures)


def label_gossip(allow_bits, Lc, idf, dist, max_sweeps):
    """Label flood with the BFS dist riding along. Returns (Lc, idf, dist,
    unconverged)."""
    return _fixpoint("labeldist", label_gossip_plain, allow_bits,
                     [Lc, idf, dist], max_sweeps)


def label_flood(allow_bits, Lc, idf, max_sweeps, closures=False):
    """Dist-free label flood. Returns (Lc, idf, unconverged)."""
    return _fixpoint("labelnd", label_flood_plain, allow_bits, [Lc, idf],
                     max_sweeps, closures)


def value_flood(L, val, max_sweeps, closures=False):
    """Min-value broadcast within same-L regions. Returns (val,
    unconverged)."""
    return _fixpoint("value", value_flood_plain, L, [val], max_sweeps,
                     closures)


def subtree_sums(pdir, s, max_sweeps):
    """Subtree sums over the parent tree given by pdir (DIRS8 index of the
    parent, 8 = none). Returns (s, unconverged)."""
    return _fixpoint("subsum", subtree_sums_plain, pdir, [s], max_sweeps)


# Launch counts live on the wrapper objects themselves (bound here, so a
# caller that re-binds the module names still counts on the originals).
_WRAPPERS = {"compmin": compmin_gossip, "labeldist": label_gossip,
             "labelnd": label_flood, "value": value_flood,
             "subsum": subtree_sums}
_CLOSURE_WRAPPERS = {"compmin": compmin_closure, "labelnd": labelnd_closure,
                     "value": value_closure}
for _fn in _WRAPPERS.values():
    _fn.launches = 0
for _fn in _CLOSURE_WRAPPERS.values():
    _fn.launches = 0
    _fn.axis_launches = [0, 0]  # [columns, rows]

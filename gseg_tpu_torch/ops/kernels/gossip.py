"""Step and hybrid fixpoints of the turbo path's stage G and final map.

Port of the entry points of `gseg_tpu/ops/pallas/gossip.py`
(`compmin_gossip`, `label_gossip`, `label_flood`, `value_flood` and
`subtree_sums`, driven as `_step_fixpoint` and `_hybrid_fixpoint` drive
them), with:

  - the step kernel: `csrc/gossip.cu`, one T-step Jacobi pass over 2D
    tiles with a T-pixel halo, one template per variant and T (4, 8, 16 or
    32 steps per pass), which skips the tiles that the previous pass left
    settled (see the note there);
    `step_pass_plain` is its plain version, one gated pass in the kernel's
    tiled form, and `_pass_loop` the pass loop that drives either;
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
passes of the pairs take STEPS_SCAN steps (the reference's T_SCAN is 4, a
VMEM and roll-cost choice on the TPU; the port keeps 8). Every step and
closure only lowers mins and raises maxes of a semilattice fixpoint whose
solution is unique, and a
round in which nothing changed contains a full step, so the exit
certifies the same fixpoint as the step-only route: the results are
bit-equal to it and to the plain version. `HYBRID_LOG` records each
hybrid call's step passes and pairs on the card. `label_gossip` and
`subtree_sums` stay step-only, as in the reference.

Steps per pass: STEPS on images narrower than PAD_MIN_WIDTH, STEPS_WIDE on
wider ones (the reference's `_pick_t`: 8, and 16 at w >= 2560; the port
keeps 8 for both, the schedule its launch counts were recorded with), and
the pass cap is ceil(max_sweeps / T) for the T of the call.

Wide images (w >= PAD_MIN_WIDTH) take the reference's padded route: the
fields are padded once on entry (`kernels.pad.fast_pad_fields`), the
passes run on the padded planes as one (hp + 2T, wp) image, and the
read-write fields are cut back once on exit (`fast_unpad_fields`). It is
exact because every fill is inert: a -1 label equals no real label, allow
bits of 0 join nothing, a pdir of 8 makes no child, and each read-write
fill is the identity of its join (so a pad pixel offers nothing and, its
own adjacency being empty, never changes; subsum pad pixels have no
parent and feed no one). The closures run on the same padded planes.

Row-sharded images (`gseg_tpu_torch.parallel`) take the spatial
fixpoints (`*_spatial`): each rank holds a row tile, and each pass runs
on the tile padded with T rows exchanged from the ranks above and below
(`_spatial_fixpoint`): the step kernel on the card at STEPS steps per
pass, the reference's one-row halo sweep on the CPU. They reach the same
unique fixpoint.
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
# Steps per pass (T) of the step kernel (csrc/gossip.cu instantiates
# STEP_COUNTS): on images narrower than PAD_MIN_WIDTH, on wider ones (the
# reference: 16), and in the hybrid route's passes after the warm passes
# (the reference's T_SCAN: 4). The row-sharded slab route takes STEPS.
STEPS = 8
STEPS_WIDE = 8
STEPS_SCAN = 8
STEP_COUNTS = (4, 8, 16, 32)
_TILE = 32            # interior side of a block in csrc/gossip.cu
_PAD_LANES = 128      # padded width multiple
_ACT_SEED = 2         # act byte of a seeded tile (csrc/gossip.cu, kActSeed)
# Settled-tile skipping in the step kernel (csrc/gossip.cu, part 1). False
# gives every pass a null act_in, which runs every tile: the same kernel
# and the same results, for chip_smoke.py's and the card tests' A/B.
TILE_SKIP = True
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
# plain version of one gated step pass (the kernel's form)
# ---------------------------------------------------------------------------


def _labeldist_join(cands, fields, ok):
    (nL, nid, nd), (Lc, idf, dist) = cands, fields
    cand = torch.where(nd >= BIGDIST, BIGDIST, nd + 1)
    adopt = ok & (nL < Lc)
    relax = ok & (nL == Lc) & (cand < dist)
    return [torch.where(adopt, nL, Lc), torch.where(ok & (nid > idf), nid, idf),
            torch.where(adopt | relax, cand, dist)]


_JOINS = {"compmin": _compmin_join, "labeldist": _labeldist_join,
          "labelnd": _labelnd_join, "value": _value_join}


def _slab_shift(x, dy, dx, fill):
    """shift_plane over the last two axes of a (N, S, S) stack of slabs."""
    return gg.shift_plane(x.permute(1, 2, 0), dy, dx, fill).permute(2, 0, 1)


def _slabs(x, fill, th, tw, t):
    """(th * tw, SLAB, SLAB): each tile's interior with a t-pixel halo,
    `fill` outside the (h, w) plane x, tiles in row-major order."""
    h, w = x.shape
    side = _TILE + 2 * t
    xp = torch.full((th * _TILE + 2 * t, tw * _TILE + 2 * t), fill,
                    dtype=x.dtype, device=x.device)
    xp[t:t + h, t:t + w] = x
    return xp.unfold(0, side, _TILE).unfold(1, side, _TILE).reshape(
        -1, side, side)


def _slab_bits(variant, ro_s, inside, ro_fill):
    """Per direction, the pixels of each slab that join that neighbour:
    both in the image (so in the slab), and the read-only plane's relation
    (same label, the allow bit, or the neighbour's pdir pointing back)."""
    kind = _RO_KIND[variant]
    ok = []
    for d, (dy, dx) in enumerate(gg.DIRS8):
        if kind == "label":
            rel = _slab_shift(ro_s, dy, dx, ro_fill) == ro_s
        elif kind == "allow":
            rel = ((ro_s >> d) & 1) > 0
        else:
            rel = _slab_shift(ro_s, dy, dx, ro_fill) == _REV[d]
        ok.append(inside & _slab_shift(inside, dy, dx, False) & rel)
    return ok


def _slab_views(x, fill):
    """The DIRS8 neighbour views of a (N, S, S) stack of slabs (view d:
    `_slab_shift(x, *DIRS8[d], fill)`), from one copy with a border."""
    n, side, _ = x.shape
    xp = torch.full((n, side + 2, side + 2), fill, dtype=x.dtype,
                    device=x.device)
    xp[:, 1:-1, 1:-1] = x
    return [xp[:, 1 + dy:1 + dy + side, 1 + dx:1 + dx + side]
            for dy, dx in gg.DIRS8]


def _slab_step(variant, fields, ok, fills):
    """One Jacobi step on every slab: each pixel folds in its joined
    neighbours' old values in DIRS8 order (subsum: 1 + the children)."""
    if variant == "subsum":
        total = torch.ones_like(fields[0])
        for d, nb in enumerate(_slab_views(fields[0], 0)):
            total = total + torch.where(ok[d], nb, 0)
        return [total]
    views = [_slab_views(x, fill) for x, fill in zip(fields, fills)]
    out = list(fields)
    for d in range(8):
        out = _JOINS[variant]([v[d] for v in views], out, ok[d])
    return out


def _word_bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def step_pass_plain(variant, ro, src, dst, act_in=None, t=None):
    """One gated t-step pass (t: one of STEP_COUNTS, default STEPS) as
    csrc/gossip.cu computes it, vectorised over tiles: each TILE x TILE
    tile whose 3 x 3 tile neighbourhood holds a nonzero act_in byte (every
    tile when act_in is None) loads its slab (a t-pixel halo, the
    variant's fills outside the image), runs t Jacobi steps on it and
    writes its interior into `dst` (in place); the other tiles leave `dst`
    as it was. Returns (dst, act_out, changed): act_out the (H/TILE,
    W/TILE) uint8 bytes, 1 where a computed tile's interior differs from
    `src` (word for word), and changed whether any does."""
    _check_fields(variant, ro, src)
    _check_fields(variant, ro, dst)
    t = _check_steps(STEPS if t is None else t)
    h, w = ro.shape
    th, tw = -(-h // _TILE), -(-w // _TILE)
    _, ro_fill, fills = _VARIANTS[variant]
    run = torch.ones((th, tw), dtype=torch.bool, device=ro.device)
    if act_in is not None:
        run = torch.nn.functional.max_pool2d(
            act_in.reshape(1, 1, th, tw).float(), 3, 1, 1)[0, 0] > 0
    idx = run.reshape(-1).nonzero()[:, 0]
    inside = _slabs(torch.ones_like(ro, dtype=torch.bool), False, th, tw,
                    t)[idx]
    ok = _slab_bits(variant, _slabs(ro, ro_fill, th, tw, t)[idx], inside,
                    ro_fill)
    cur = [_slabs(x, fill, th, tw, t)[idx] for x, fill in zip(src, fills)]
    for _ in range(t):
        cur = _slab_step(variant, cur, ok, fills)
    px_run = run.repeat_interleave(_TILE, 0).repeat_interleave(_TILE, 1)
    px_run = px_run[:h, :w]
    diff = torch.zeros((th * _TILE, tw * _TILE), dtype=torch.bool,
                       device=ro.device)
    for x_src, x_dst, c in zip(src, dst, cur):
        tiles = torch.zeros((th * tw, _TILE, _TILE), dtype=c.dtype,
                            device=c.device)
        tiles[idx] = c[:, t:t + _TILE, t:t + _TILE]
        new = tiles.view(th, tw, _TILE, _TILE).transpose(1, 2).reshape(
            th * _TILE, tw * _TILE)[:h, :w]
        new = torch.where(px_run, new, x_src)
        diff[:h, :w] |= _word_bits(new) != _word_bits(x_src)
        x_dst.copy_(torch.where(px_run, new, x_dst))
    act_out = diff.view(th, _TILE, tw, _TILE).any(3).any(1).to(torch.uint8)
    return dst, act_out, bool(act_out.any())


# ---------------------------------------------------------------------------
# kernel passes
# ---------------------------------------------------------------------------

# variant -> (C entry point, fill of the read-only plane, fills of the
# read-write fields); the fills pad the fields on the wide-image route. The
# order is the kernel's variant index (csrc/gossip.cu, g_tiles).
_VARIANTS = {
    "compmin": ("gseg_compmin_pass", -1, (torch.inf, INT32_MAX, 0)),
    "labeldist": ("gseg_labeldist_pass", 0, (INT32_MAX, 0.0, BIGDIST)),
    "labelnd": ("gseg_labelnd_pass", 0, (INT32_MAX, 0.0)),
    "value": ("gseg_value_pass", -1, (INT32_MAX,)),
    "subsum": ("gseg_subsum_pass", 8, (0,)),
}
# variant -> what its read-only plane holds (csrc/gossip.cu, Ro)
_RO_KIND = {"compmin": "label", "labeldist": "allow", "labelnd": "allow",
            "value": "label", "subsum": "pdir"}
# Tiles launched by the step kernel per variant, counted on the host:
# [every pass, seeded first passes]. The device counts the tiles computed
# (tile_counts); chip_smoke.py reads both.
TILE_LAUNCHES = {v: [0, 0] for v in _VARIANTS}


# variant -> C entry point of its closure launch (csrc/closure.cu)
_CLOSURE_ENTRIES = {"compmin": "gseg_compmin_closure",
                    "labelnd": "gseg_labelnd_closure",
                    "value": "gseg_value_closure"}
_closure_max_width: dict[int, int] = {}


def _lib():
    with _build.LOCK:
        lib = _build.load("gossip")
        if getattr(lib, "gseg_bound", False):
            return lib
        for fname, _, fills in _VARIANTS.values():
            fn = getattr(lib, fname)
            fn.argtypes = ([ctypes.c_void_p] * (1 + 2 * len(fills))
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
            fn.restype = ctypes.c_int
        for fname in ("gseg_gossip_tile", "gseg_gossip_reset_tile_counts"):
            getattr(lib, fname).argtypes = []
            getattr(lib, fname).restype = ctypes.c_int
        lib.gseg_gossip_has_steps.argtypes = [ctypes.c_int]
        lib.gseg_gossip_has_steps.restype = ctypes.c_int
        lib.gseg_gossip_tile_counts.argtypes = [ctypes.c_void_p]
        lib.gseg_gossip_tile_counts.restype = ctypes.c_int
        got = ([t for t in STEP_COUNTS if lib.gseg_gossip_has_steps(t)],
               lib.gseg_gossip_tile())
        if got != (list(STEP_COUNTS), _TILE):
            raise RuntimeError(
                f"csrc/gossip.cu has (steps per pass, TILE) {got}; this "
                f"module expects {(list(STEP_COUNTS), _TILE)}")
        lib.gseg_bound = True
        return lib


def tile_counts():
    """Since the last reset_tile_counts(), per variant: (tiles the step
    kernel computed in unseeded passes, in seeded first passes, the in-tile
    steps they ran). Reads device counters back (synchronous); the main
    path never calls it."""
    buf = (ctypes.c_ulonglong * (3 * len(_VARIANTS)))()
    _build.check(_lib().gseg_gossip_tile_counts(buf),
                 "gseg_gossip_tile_counts")
    return {v: tuple(buf[3 * i:3 * i + 3]) for i, v in enumerate(_VARIANTS)}


def reset_tile_counts():
    """Zero the device's computed-tile counts and TILE_LAUNCHES."""
    _build.check(_lib().gseg_gossip_reset_tile_counts(),
                 "gseg_gossip_reset_tile_counts")
    with _build.LOCK:
        for counts in TILE_LAUNCHES.values():
            counts[:] = [0, 0]


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


def _check_steps(t):
    """t, if the step kernel is instantiated for t steps per pass (checked
    on every device, so the CPU tests catch what the kernel would
    refuse)."""
    if t not in STEP_COUNTS:
        raise ValueError(f"steps per pass must be one of {STEP_COUNTS}; "
                         f"got {t}")
    return t


def _check_contiguous(variant, planes):
    if not all(x.is_contiguous() for x in planes):
        raise ValueError(f"{variant}: the kernel takes contiguous planes")


def _fixpoint(variant, plain, ro, fields, max_sweeps, closures=False,
              seed_mask=None):
    """The plain version for CPU tensors (it ignores seed_mask), the kernel
    passes for CUDA tensors (the hybrid route with closures). Returns
    (*fields, unconverged)."""
    _check_fields(variant, ro, fields)
    extra = []
    if seed_mask is not None:
        if seed_mask.dtype != torch.bool or seed_mask.shape != ro.shape:
            raise ValueError(f"{variant}: seed_mask must be a bool plane of "
                             f"shape {tuple(ro.shape)}")
        extra = [seed_mask]
    if _build.on_cpu(ro, *fields, *extra):
        return plain(ro, *fields, max_sweeps)
    out, unconv = _run_fixpoint(variant, ro, fields, max_sweeps, closures,
                                seed_mask)
    return (*out, unconv)


def _seed_act(seed_mask, h, w, row0):
    """The first pass's act bytes: kActSeed for each tile of the (h, w)
    kernel plane that holds a seed pixel, with the mask placed at row
    `row0` (a block max: one max-pool)."""
    th, tw = -(-h // _TILE), -(-w // _TILE)
    m = torch.zeros((th * _TILE, tw * _TILE), dtype=torch.uint8,
                    device=seed_mask.device)
    m[row0:row0 + seed_mask.shape[0], :seed_mask.shape[1]] = seed_mask
    return m.view(th, _TILE, tw, _TILE).amax((1, 3)) * _ACT_SEED


def _run_fixpoint(variant, ro, fields, max_sweeps, closures, seed_mask=None,
                  passes=None):
    """Jacobi passes (double-buffered) of T steps (STEPS, or STEPS_WIDE on
    wide images) until one changes nothing or the pass cap
    ceil(max_sweeps / T) is reached, the hybrid route with closures; wide
    images on padded planes (module note). passes: what drives the passes
    on the (padded) planes, with `_passes`' arguments (None: `_passes`,
    the kernels; the CPU tests give the kernels' plain versions). Returns
    (fields, unconverged)."""
    _check_contiguous(f"{variant} fixpoint", (ro, *fields))
    _, ro_fill, fills = _VARIANTS[variant]
    h0, w0 = ro.shape
    padded = w0 >= PAD_MIN_WIDTH
    t = _check_steps(STEPS_WIDE if padded else STEPS)
    max_passes = -(-max_sweeps // t)
    if padded:
        hp = -(-h0 // _TILE) * _TILE
        wp = -(-w0 // _PAD_LANES) * _PAD_LANES
        ro, *fields = kp.fast_pad_fields(
            [(ro, ro_fill), *zip(fields, fills)], t, hp, wp)
    seed_act = None
    if seed_mask is not None and TILE_SKIP:
        seed_act = _seed_act(seed_mask, *ro.shape, t if padded else 0)
    fields, unconv = (passes or _passes)(variant, ro, fields, max_passes,
                                         closures, seed_act, t)
    if padded:
        fields = kp.fast_unpad_fields(fields, t, h0, w0)
    return fields, unconv


def _pass_loop(step, close, fields, bufs, acts, changed, max_passes, warm,
               seed_act=None, gate=True, scan_step=None):
    """The pass loop of one fixpoint, its launches passed in (so the CPU
    tests can drive it with step_pass_plain).

    step(src, dst, act_in, act_out): one step pass from the fields `src`
    into `dst`, running the tiles that act_in wakes (None: every tile),
    writing act_out and ORing the device word `changed`. close(fields,
    axis): one closure launch in place, ORing `changed` (None: step-only).
    Up to `warm` step passes, then (with close) pairs of (step pass + rows
    closure) and (step pass + columns closure), each pair one pass against
    the cap, until a pass or pair changes nothing or the cap is reached;
    the pairs' step passes run `scan_step` (None: `step`), which may take
    another T (the act bytes stay sound across it: csrc/gossip.cu, 4).
    The first pass reads `fields`, later ones ping-pong between the two
    scratch sets `bufs` (the closures update one in place), so the inputs
    are never written. gate: each step gets the previous step's act bytes
    (the first, seed_act), and None after a closure, which rewrites the
    planes. A skipped tile leaves its destination as it was, so the sets it
    may skip into first hold the input: the second before pass 2, the
    first too when pass 1 is seeded (note in csrc/gossip.cu). Returns
    (fields, unconverged, step passes, pairs)."""
    if gate:
        for b, x in zip(bufs[1], fields):
            b.copy_(x)
        if seed_act is not None:
            for b, x in zip(bufs[0], fields):
                b.copy_(x)
    src, n, act_in = list(fields), 0, seed_act if gate else None

    def run(fn):
        nonlocal src, n, act_in
        dst, act_out = bufs[n % 2], acts[n % 2]
        fn(src, dst, act_in, act_out)
        src, n, act_in = dst, n + 1, act_out if gate else None

    for _ in range(warm):
        changed.zero_()
        run(step)
        if int(changed.item()) == 0:
            return src, False, n, 0
    if close is None:
        return src, True, n, 0
    pairs = 0
    while warm + pairs < max_passes:
        changed.zero_()
        for axis in (1, 0):
            run(scan_step or step)
            close(src, axis)
            act_in = None
        pairs += 1
        if int(changed.item()) == 0:
            return src, False, n, pairs
    return src, True, n, pairs


def _launch_pass(variant, ro, src, dst, act_in, act_out, changed, stream, t):
    """One t-step kernel launch on contiguous CUDA planes."""
    h, w = ro.shape
    err = getattr(_lib(), _VARIANTS[variant][0])(
        ro.data_ptr(), *[x.data_ptr() for x in src],
        *[x.data_ptr() for x in dst], h, w, t,
        None if act_in is None else act_in.data_ptr(), act_out.data_ptr(),
        changed.data_ptr(), stream)
    _build.check(err, f"gseg_{variant}_pass")
    with _build.LOCK:
        _WRAPPERS[variant].launches += 1
        TILE_LAUNCHES[variant][0] += act_out.numel()


def _passes(variant, ro, fields, max_passes, closures, seed_act, t):
    """Allocates the scratch sets and act bytes and drives _pass_loop with
    the kernel at t steps per pass (the closure pairs' at STEPS_SCAN).
    Returns (fields, unconverged)."""
    h, w = ro.shape
    tiles = (-(-h // _TILE), -(-w // _TILE))
    bufs = [[torch.empty_like(x) for x in fields] for _ in range(2)]
    acts = [torch.empty(tiles, dtype=torch.uint8, device=ro.device)
            for _ in range(2)]
    changed = torch.zeros(1, dtype=torch.int32, device=ro.device)
    warm = min(max_passes, WARM_PASSES) if closures else max_passes
    clib = _closure_lib() if closures else None
    t_scan = _check_steps(STEPS_SCAN) if closures else t
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream().cuda_stream

        def step(src, dst, act_in, act_out, t=t):
            _launch_pass(variant, ro, src, dst, act_in, act_out, changed,
                         stream, t)
            if act_in is not None and act_in is seed_act:
                with _build.LOCK:
                    TILE_LAUNCHES[variant][1] += act_out.numel()

        def scan_step(src, dst, act_in, act_out):
            step(src, dst, act_in, act_out, t_scan)

        def close(src, axis):
            _closure_launch(variant, clib, ro, src, axis, changed, stream)

        out, unconv, n, pairs = _pass_loop(
            step, close if closures else None, fields, bufs, acts, changed,
            max_passes, warm, seed_act, TILE_SKIP, scan_step)
    if closures:
        HYBRID_LOG.append((variant, min(n, warm), pairs))
    return out, unconv


def step_pass(variant, ro, src, dst, act_in=None, t=None):
    """One t-step pass (one of STEP_COUNTS, default STEPS) of `variant`
    from the fields `src` into `dst`, gated by act_in (the previous pass's
    act bytes, or None for every tile): the kernel for CUDA tensors,
    step_pass_plain for CPU tensors. Returns (dst, act_out, changed); the
    card's checks hold the two against each other pass by pass."""
    _check_fields(variant, ro, src)
    _check_fields(variant, ro, dst)
    t = _check_steps(STEPS if t is None else t)
    h, w = ro.shape
    tiles = (-(-h // _TILE), -(-w // _TILE))
    gate = []
    if act_in is not None:
        if act_in.dtype != torch.uint8 or act_in.shape != tiles:
            raise ValueError(f"{variant} step pass: act_in must be uint8 of "
                             f"shape {tiles}")
        gate = [act_in]
    if _build.on_cpu(ro, *src, *dst, *gate):
        return step_pass_plain(variant, ro, src, dst, act_in, t)
    _check_contiguous(f"{variant} step pass", (ro, *src, *dst, *gate))
    act_out = torch.empty(tiles, dtype=torch.uint8, device=ro.device)
    changed = torch.zeros(1, dtype=torch.int32, device=ro.device)
    with torch.cuda.device(ro.device):
        _launch_pass(variant, ro, src, dst, act_in, act_out, changed,
                     torch.cuda.current_stream().cuda_stream, t)
    return dst, act_out, bool(changed.item())


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
    with _build.LOCK:
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


def label_flood(allow_bits, Lc, idf, max_sweeps, closures=False,
                seed_mask=None):
    """Dist-free label flood. Returns (Lc, idf, unconverged).

    seed_mask: optional (H, W) bool, True where a hook (cross-label allow)
    edge touches. On the card the first pass then runs only the tiles whose
    3 x 3 tile neighbourhood holds a seed pixel. Caller's contract (the
    reference's): away from hooks, Lc and idf are uniform per old
    component, so an unseeded tile's first pass changes nothing. The plain
    version ignores it."""
    return _fixpoint("labelnd", label_flood_plain, allow_bits, [Lc, idf],
                     max_sweeps, closures, seed_mask)


def value_flood(L, val, max_sweeps, closures=False):
    """Min-value broadcast within same-L regions. Returns (val,
    unconverged)."""
    return _fixpoint("value", value_flood_plain, L, [val], max_sweeps,
                     closures)


def subtree_sums(pdir, s, max_sweeps):
    """Subtree sums over the parent tree given by pdir (DIRS8 index of the
    parent, 8 = none). Returns (s, unconverged)."""
    return _fixpoint("subsum", subtree_sums_plain, pdir, [s], max_sweeps)


# ---------------------------------------------------------------------------
# spatial fixpoints: one image row-sharded over the ranks of a mesh
# ---------------------------------------------------------------------------


def _slab_step_kernel(variant, ro, src, dst):
    """One ungated STEPS-step kernel pass over a row slab (contiguous CUDA
    planes); the kernel's `changed` word is not read (see
    _spatial_fixpoint)."""
    _check_contiguous(f"{variant} slab pass", (ro, *src, *dst))
    h, w = ro.shape
    act_out = torch.empty((-(-h // _TILE), -(-w // _TILE)), dtype=torch.uint8,
                          device=ro.device)
    changed = torch.zeros(1, dtype=torch.int32, device=ro.device)
    with torch.cuda.device(ro.device):
        _launch_pass(variant, ro, src, dst, None, act_out, changed,
                     torch.cuda.current_stream().cuda_stream, STEPS)


def _spatial_fixpoint(variant, plain, ro, fields, max_sweeps, rank,
                      step=None):
    """The fixpoint of `variant` over a row tile of a row-sharded image.

    rank: this rank's collectives (`parallel.mesh.Rank`): halos(xs, k,
    fills), the tiles with the k rows above and below them in the global
    plane (the fills outside the image), and any(local) -> bool over every
    rank. Each pass pads the tile's planes to a slab with k exchanged rows
    a side (the variant's inert fills outside the image, as on the padded
    route), runs k steps on it and keeps the tile's own rows, which are
    then exactly k global steps further: a row's new value depends only on
    rows at most k away, all in the slab. The halo rows come fresh from
    their owners each pass.

    step(variant, ro, src, dst): one pass over a slab. None: on CUDA
    tensors the step kernel (k = T, at most ceil(max_sweeps / T) passes,
    ungated: no tile skipping, seed or closures, none of which is local
    across ranks); on CPU tensors the reference's one-row halo sweep (k =
    1, at most max_sweeps sweeps): one sweep of `plain` on the slab, whose
    inner rows read only rows of the slab. Another step
    (`step_pass_plain`, in tests) runs the slab route with k = T on any
    device.

    `changed` is decided on the tile's own rows only, compared word for
    word with the pass's input, then ORed over the ranks: the slab's outer
    halo rows have lost their neighbours beyond the slab and may change on
    every pass (subtree sums there miss the children outside; a fill row
    sums to 1), so they never stop the loop. Returns (*fields,
    unconverged), the same on every rank."""
    _check_fields(variant, ro, fields)
    _, ro_fill, fills = _VARIANTS[variant]
    h = ro.shape[0]
    if step is None and _build.on_cpu(ro, *fields):
        k, max_passes = 1, max_sweeps
        ro_s = rank.halo(ro, 1, ro_fill)

        def one_pass(src):
            return [x[1:-1] for x in plain(ro_s, *src, 1)[:-1]]
    else:
        step = step or _slab_step_kernel
        k, max_passes = STEPS, -(-max_sweeps // STEPS)
        ro_s = rank.halo(ro, k, ro_fill)

        def one_pass(src):
            dst = [torch.empty_like(x) for x in src]
            step(variant, ro_s, src, dst)
            return [x[k:k + h] for x in dst]

    # the OR of each pass's changed flag rides on the next pass's halo
    # exchange (the last pass's alone).
    cur, src, n = list(fields), rank.halos(fields, k, fills), 0
    while True:
        new = one_pass(src)
        diff = torch.zeros((), dtype=torch.bool, device=ro.device)
        for a, b in zip(new, cur):
            diff |= (_word_bits(a) != _word_bits(b)).any()
        cur, n = new, n + 1
        if n >= max_passes:
            return (*cur, rank.any(diff))
        src, changed = rank.halos(cur, k, fills, diff)
        if not changed:
            return (*cur, False)


def compmin_gossip_spatial(L, bw, be, sz, max_sweeps, rank, idle=False,
                           step=None):
    """compmin_gossip on a row tile (see _spatial_fixpoint). Returns (bw,
    be, sz, unconverged)."""
    if idle:
        return bw, be, sz, False
    return _spatial_fixpoint("compmin", compmin_gossip_plain, L,
                             [bw, be, sz], max_sweeps, rank, step)


def label_gossip_spatial(allow_bits, Lc, idf, dist, max_sweeps, rank,
                         step=None):
    """label_gossip on a row tile. Returns (Lc, idf, dist, unconverged)."""
    return _spatial_fixpoint("labeldist", label_gossip_plain, allow_bits,
                             [Lc, idf, dist], max_sweeps, rank, step)


def label_flood_spatial(allow_bits, Lc, idf, max_sweeps, rank, step=None):
    """label_flood on a row tile. Returns (Lc, idf, unconverged)."""
    return _spatial_fixpoint("labelnd", label_flood_plain, allow_bits,
                             [Lc, idf], max_sweeps, rank, step)


def value_flood_spatial(L, val, max_sweeps, rank, step=None):
    """value_flood on a row tile. Returns (val, unconverged)."""
    return _spatial_fixpoint("value", value_flood_plain, L, [val],
                             max_sweeps, rank, step)


def subtree_sums_spatial(pdir, s, max_sweeps, rank, step=None):
    """subtree_sums on a row tile; the parent tree may cross the tiles.
    Returns (s, unconverged)."""
    return _spatial_fixpoint("subsum", subtree_sums_plain, pdir, [s],
                             max_sweeps, rank, step)


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

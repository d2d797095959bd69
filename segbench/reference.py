"""The plain reference: sequential Boruvka-Felzenszwalb in NumPy, frozen.

A copy of the program's executable specification
(`gseg_tpu_torch/models/boruvka_cpu.py`), kept here so that the yardstick
does not move when the program does; it imports nothing of the program.
From an (H, W, 3) uint8 frame it works the partition out again: Gaussian
smoothing (edge padding, taps in a fixed float32 order), the 8-connected
edge weights (float32 Euclidean colour distance, the root rounded once),
round-based Boruvka with canonical edge ids breaking ties, the
Felzenszwalb predicate in multiply form, quality mode's weight-quantile
bucket ramp (one bucket a round), then the min-size rounds.
`canonical_labels` relabels each component by its least pixel id, the form
the turbo path returns.

`precision="bfloat16"` is the control: the smoothed frame and the edge
weights are rounded to bfloat16 (nearest, ties to even), the precision
below the float32 that the configuration states.
"""

from __future__ import annotations

import math

import numpy as np

INT32_MAX = np.iinfo(np.int32).max
# the configuration keys that the reference follows
KEYS = ("sigma", "k", "min_size", "max_iters", "connectivity",
        "weight_buckets")

_DIRS4 = ((0, 1), (1, 0), (1, 1), (1, -1))


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    returned as float32; infinities stay."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = ((u >> 16) & 1) + np.uint32(0x7FFF)
    return ((u + r) & np.uint32(0xFFFF0000)).view(np.float32)


def _shift_sum(a: np.ndarray, taps, axis: int) -> np.ndarray:
    """Convolve along `axis` with edge padding as a sum of shifted, scaled
    copies, taps in order."""
    radius = (len(taps) - 1) // 2
    pad = [(0, 0)] * a.ndim
    pad[axis] = (radius, radius)
    p = np.pad(a, pad, mode="edge")
    n = a.shape[axis]
    out = np.zeros_like(a)
    for i, t in enumerate(taps):
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(i, i + n)
        out = out + np.float32(t) * p[tuple(sl)]
    return out


def gaussian_smooth(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian, radius ceil(4 sigma), normalised float32 taps."""
    img = img.astype(np.float32)
    sigma = max(float(sigma), 1e-2)
    radius = max(int(math.ceil(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)
    k = (k / np.sum(k)).astype(np.float32)
    return _shift_sum(_shift_sum(img, k, 0), k, 1)


def edge_weights(img: np.ndarray, connectivity: int = 8) -> np.ndarray:
    """(4, H, W) float32 canonical edge planes (E, S, SE, NE), +inf where
    the neighbour is outside the frame."""
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w = img.shape[:2]
    weights = np.full((4, h, w), np.inf, dtype=np.float32)
    ndirs = 4 if connectivity == 8 else 2
    for d, (dy, dx) in enumerate(_DIRS4[:ndirs]):
        ys = slice(0, h - dy)
        xs = slice(max(-dx, 0), w - max(dx, 0))
        ys2 = slice(dy, h)
        xs2 = slice(max(dx, 0), w + min(dx, 0))
        diff = img[ys, xs] - img[ys2, xs2]
        weights[d, ys, xs] = np.sqrt(np.sum(diff * diff, axis=-1))
    return weights


def bucket_thresholds(weights: np.ndarray, num_buckets: int) -> np.ndarray:
    """Quality mode's caps: threshold b is the ((b+1)/N)-quantile of a
    stride sample (at most 65536) of the finite weights in edge-id order;
    the last is +inf."""
    flat = np.asarray(weights).transpose(1, 2, 0).reshape(-1)
    stride = max(flat.size // 65536, 1)
    sample = flat[::stride][:65536].astype(np.float32)
    sample = np.where(np.isfinite(sample), sample, np.float32(np.inf))
    sample = np.sort(sample)
    n_fin = int(np.isfinite(sample).sum())
    out = np.full(num_buckets, np.inf, dtype=np.float32)
    for b in range(num_buckets - 1):
        idx = min(max(((b + 1) * n_fin) // num_buckets - 1, 0),
                  max(n_fin - 1, 0))
        out[b] = sample[idx] if n_fin else np.float32(np.inf)
    return out


def _edge_arrays(weights: np.ndarray, w: int):
    """Canonical planes as edge arrays indexed by eid = anchor * 4 + d."""
    h = weights.shape[1]
    v = h * w
    offs = np.array([dy * w + dx for dy, dx in _DIRS4], dtype=np.int64)
    valid = np.isfinite(weights).transpose(1, 2, 0).reshape(-1)
    ew = weights.transpose(1, 2, 0).reshape(-1)
    a = np.repeat(np.arange(v, dtype=np.int64), 4)
    b = np.where(valid, a + np.tile(offs, v), 0)
    return a, b, ew, valid


def _flatten(p: np.ndarray) -> np.ndarray:
    while True:
        p2 = p[p]
        if np.array_equal(p2, p):
            return p
        p = p2


def segment(image: np.ndarray, sigma: float, k: float, min_size: int,
            max_iters: int, connectivity: int = 8, weight_buckets: int = 0,
            precision: str = "float32") -> np.ndarray:
    """(H, W) int32 labels (root vertex ids) of an (H, W, C) frame."""
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"precision must be float32 or bfloat16, got "
                         f"{precision!r}")
    low = precision == "bfloat16"
    h, w = image.shape[0], image.shape[1]
    v = h * w
    sm = gaussian_smooth(image, sigma)
    weights = edge_weights(to_bfloat16(sm) if low else sm, connectivity)
    if low:
        weights = to_bfloat16(weights)
    ea, eb, ew, ev = _edge_arrays(weights, w)
    live = np.nonzero(ev)[0]
    ea, eb, ew = ea[live], eb[live], ew[live]
    eid = live.astype(np.int64)
    offs = np.array([dy * w + dx for dy, dx in _DIRS4], dtype=np.int64)
    idx = np.arange(v, dtype=np.int64)

    if weight_buckets > 0:
        thresholds = bucket_thresholds(weights, weight_buckets)
    else:
        thresholds = np.array([np.inf], dtype=np.float32)

    def one_phase(mode, parent, size, intdiff):
        # quality mode: the cap advances one bucket per round, not per
        # convergence.
        bucket = 0
        for _ in range(max_iters + len(thresholds)):
            tau = (thresholds[min(bucket, len(thresholds) - 1)]
                   if mode == "felz" else np.float32(np.inf))
            ra, rb = parent[ea], parent[eb]
            out = (ra != rb) & (ew <= tau)
            # each component's least eligible outgoing edge, ties to the
            # least edge id
            comp_minw = np.full(v, np.inf, dtype=np.float32)
            np.minimum.at(comp_minw, ra[out], ew[out])
            np.minimum.at(comp_minw, rb[out], ew[out])
            comp_eid = np.full(v, INT32_MAX, dtype=np.int64)
            besta = out & (ew == comp_minw[ra])
            bestb = out & (ew == comp_minw[rb])
            np.minimum.at(comp_eid, ra[besta], eid[besta])
            np.minimum.at(comp_eid, rb[bestb], eid[bestb])
            has = comp_eid != INT32_MAX

            sa = np.where(has, comp_eid // 4, 0)
            sb = sa + offs[np.where(has, comp_eid % 4, 0)]
            rsa, rsb = parent[sa], parent[sb]
            other = np.where(rsa == idx, rsb, rsa)
            cw = np.where(has, comp_minw, np.inf).astype(np.float32)

            if mode == "felz":
                # (w - Int(C)) * |C| <= k: the multiply form rounds alike
                # everywhere; stale non-root slots (0 * inf) are masked by
                # `has`.
                kf = np.float32(k)
                with np.errstate(invalid="ignore"):
                    lhs_self = (cw - intdiff) * size.astype(np.float32)
                    lhs_other = ((cw - intdiff[other])
                                 * size[other].astype(np.float32))
                ok = (lhs_self <= kf) & (lhs_other <= kf)
            else:
                ok = size < min_size
            hook = has & ok

            succ = np.where(hook, other, idx)
            mutual = (succ[succ] == idx) & (succ != idx)
            succ = np.where(mutual & (idx < succ), idx, succ)
            used = succ != idx
            if mode == "felz":
                bucket += 1
            if not used.any():
                if mode == "felz" and bucket < len(thresholds):
                    continue  # buckets remain: keep raising the cap
                break

            new_root = _flatten(succ)
            parent_new = new_root[parent]
            is_root = parent == idx
            size_new = np.zeros(v, dtype=np.int64)
            np.add.at(size_new, parent_new[is_root], size[is_root])
            intdiff_new = np.zeros(v, dtype=np.float32)
            np.maximum.at(intdiff_new, parent_new[is_root], intdiff[is_root])
            np.maximum.at(intdiff_new, parent_new[used], cw[used])
            parent, size, intdiff = parent_new, size_new, intdiff_new
        return parent, size, intdiff

    state = (idx.copy(), np.ones(v, dtype=np.int64),
             np.zeros(v, dtype=np.float32))
    state = one_phase("felz", *state)
    if min_size > 1:
        state = one_phase("minsize", *state)
    return state[0].astype(np.int32).reshape(h, w)


def canonical_labels(labels: np.ndarray) -> np.ndarray:
    """Each component relabelled by its least flat pixel id (int32): two
    label maps are the same partition iff these are equal."""
    flat = np.asarray(labels).ravel()
    uniq, inv = np.unique(flat, return_inverse=True)
    minid = np.full(uniq.shape, np.iinfo(np.int64).max)
    np.minimum.at(minid, inv, np.arange(flat.size))
    return minid[inv].reshape(np.asarray(labels).shape).astype(np.int32)


def reference_partition(image: np.ndarray, cfg: dict,
                        precision: str = "float32") -> np.ndarray:
    """The canonical partition of one frame under a configuration file's
    settings (its keys in KEYS)."""
    return canonical_labels(segment(
        image, sigma=cfg["sigma"], k=cfg["k"], min_size=cfg["min_size"],
        max_iters=cfg["max_iters"], connectivity=cfg["connectivity"],
        weight_buckets=cfg["weight_buckets"], precision=precision))

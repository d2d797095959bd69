"""The DPP Boruvka-Felzenszwalb schedule in plain PyTorch: the reference
that the fastmst path's labels are held to on any device.

It follows Vineet, Harish, Patidar and Narayanan, "Fast Minimum Spanning
Tree for Large Graphs on the GPU" (HPG 2009), with the Felzenszwalb merge
predicate, as the report's DPP Segmentation Hierarchies use it (Report.pdf
p.3-4 sec 3.2.2). From an (H, W, 3) uint8 frame, in float32:

  1. Gaussian smoothing, edge padding, radius ceil(4 sigma), normalised
     float32 taps added in a fixed order (rows, then columns);
  2. the 8-connected grid graph as one list of undirected edges, each with
     its canonical id eid = anchor * 4 + d (d: E, S, SE, NE) and its
     float32 Euclidean colour distance (the float64 root rounded once);
     the list is sorted once by (w, eid), and an edge's place in that
     order is its rank;
  3. Boruvka rounds until no component hooks: both directions of every
     edge whose ends lie in different components, keyed by (component,
     rank) in one int64 word and sorted, so that the head of each
     component's run is its least outgoing edge (the segmented min);
     a component hooks onto the other end's component when
     (w - Int(C)) |C| <= k holds for both (the predicate
     w <= min(Int(C1) + k/|C1|, Int(C2) + k/|C2|) in multiply form);
     of a mutual pair the smaller id keeps itself; pointer jumping takes
     every successor to its root; each vertex is relabelled by its
     component's new root, sizes add up and Int is the largest of the
     merged Ints and the hooking weights;
  4. the min-size rounds: the same rounds with the predicate |C| <
     min_size on the hooking component alone.

The labels are root vertex ids (each pixel holds the id of its
component's hook-sink root), the form the port's fastmst and atomic paths
return. It imports no module of the port and uses no kernel, capacity,
chunked sort or recompaction: one edge list, whole, every round.
The atomic path (`models/atomic_boruvka.py`, `segment()`'s default) is
held to these labels byte for byte as well: on the CPU by the `atomic`
cases of `tests/test_torch_fastmst_plain.py::
test_fastmst_byte_equal_to_plain` and by
`test_full_range_noise_atomic_byte_equal_to_plain`, on the card by
`test_fastmst_byte_equal_to_plain_on_card[atomic-*]` at 270x480 and
3840x2160.

Departures from Vineet et al. and from the report's implementation:

  - ties between equal weights are broken by the canonical edge id, so the
    result is one fixed partition; the report's code packed two 26-bit
    endpoint ids and a 12-bit weight into its sort keys and did not fix
    the order of ties;
  - weights are float32 and exact, not quantised to 12 bits;
  - supervertex ids are root vertex ids: no split compacts them into
    0..n-1 between rounds, and the edge list is not compacted (edges
    inside a component are masked, not removed);
  - the MST's cycle step keeps the smaller id of a mutual pair, as
    Vineet et al. do; the Felzenszwalb predicate then holds a hook back,
    which MST does not;
  - the min-size pass is Boruvka rounds with the size predicate, not
    Felzenszwalb's sequential pass in weight order;
  - each phase stops after max_iters + 1 rounds, as the port's NumPy
    oracle does (a frame never needs as many).

`precision="bfloat16"` rounds the smoothed frame and the edge weights to
bfloat16 (nearest, ties to even): the precision below the float32 the
configuration states, for controls that must come out different.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the four canonical directions of an anchor's edges: E, S, SE, NE
DIRS4 = ((0, 1), (1, 0), (1, 1), (1, -1))


def to_bfloat16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest bfloat16, as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def gaussian_taps(sigma: float) -> torch.Tensor:
    """Normalised float32 taps of radius ceil(4 sigma). These few numbers
    are worked out on the host in NumPy's float32, by the expressions of
    the specification, so that every implementation holds the same taps
    (torch's float32 exp and sum may round another way)."""
    sigma = max(float(sigma), 1e-2)
    radius = max(int(math.ceil(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)
    return torch.from_numpy((k / np.sum(k)).astype(np.float32))


def _shift_sum(a: torch.Tensor, taps: torch.Tensor, axis: int):
    """Convolve along `axis` with edge padding: a sum of shifted copies,
    each times its float32 tap, added in the taps' order."""
    radius = (taps.numel() - 1) // 2
    n = a.shape[axis]
    idx = torch.arange(-radius, n + radius, device=a.device).clamp(0, n - 1)
    padded = a.index_select(axis, idx)
    out = torch.zeros_like(a)
    for i in range(taps.numel()):
        out = out + taps[i] * padded.narrow(axis, i, n)
    return out


def gaussian_smooth(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """(H, W, C) frame -> float32, smoothed down the rows, then along."""
    img = img.to(torch.float32)
    taps = gaussian_taps(sigma).to(img.device)
    return _shift_sum(_shift_sum(img, taps, 0), taps, 1)


def edge_weights(img: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """(4, H, W) float32 weights of the canonical edges (E, S, SE, NE) of
    each anchor pixel; +inf where the neighbour is outside the frame (and
    on the diagonals when connectivity is 4). The channel sum runs left to
    right; the root is the float64 one rounded once, which is correctly
    rounded on every device."""
    h, w = img.shape[0], img.shape[1]
    out = torch.full((4, h, w), math.inf, dtype=torch.float32,
                     device=img.device)
    for d, (dy, dx) in enumerate(DIRS4[:4 if connectivity == 8 else 2]):
        x0, x1 = max(-dx, 0), w - max(dx, 0)
        diff = img[:h - dy, x0:x1] - img[dy:, x0 + dx:x1 + dx]
        sq = diff * diff
        acc = sq[..., 0]
        for c in range(1, sq.shape[-1]):
            acc = acc + sq[..., c]
        out[d, :h - dy, x0:x1] = torch.sqrt(acc.double()).float()
    return out


def _pointer_jump(succ: torch.Tensor) -> torch.Tensor:
    """Each vertex's root under the successor map (roots map to
    themselves)."""
    while True:
        nxt = succ[succ]
        if torch.equal(nxt, succ):
            return succ
        succ = nxt


def segment(image, sigma: float = 0.8, k: float = 300.0,
            min_size: int = 100, max_iters: int = 32, connectivity: int = 8,
            precision: str = "float32", device=None) -> torch.Tensor:
    """(H, W, 3) frame (NumPy array or tensor) -> (H, W) int32 root vertex
    ids on `device` (default: the frame's, the CPU for an array). TF32 is
    off for the call (float32 means float32, though no step is a matmul
    or a convolution), and the process's settings are restored after."""
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"precision must be float32 or bfloat16, got "
                         f"{precision!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _segment(image, sigma, k, min_size, max_iters, connectivity,
                        precision, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _segment(image, sigma, k, min_size, max_iters, connectivity, precision,
             device):
    img = torch.as_tensor(image, device=device)
    dev = img.device
    img = img.to(torch.float32)
    if img.ndim == 2:
        img = img[..., None]
    low = precision == "bfloat16"
    h, w = img.shape[0], img.shape[1]
    v = h * w

    sm = gaussian_smooth(img, sigma)
    weights = edge_weights(to_bfloat16(sm) if low else sm, connectivity)
    if low:
        weights = to_bfloat16(weights)

    # the edge list, whole: canonical ids in ascending order, then their
    # ranks in (w, eid) order (a stable sort keeps eid order on ties)
    flat = weights.permute(1, 2, 0).reshape(-1)
    eid = torch.nonzero(torch.isfinite(flat)).squeeze(1)
    ew = flat[eid]
    offs = torch.tensor([dy * w + dx for dy, dx in DIRS4], device=dev)
    ea = eid // 4
    eb = ea + offs[eid % 4]
    n_e = eid.numel()
    order = torch.sort(ew, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_e, device=dev)
    w_by_rank = ew[order]
    kf = torch.tensor(k, dtype=torch.float32, device=dev)
    idx = torch.arange(v, device=dev)

    def rounds(parent, size, intdiff, felz: bool):
        for _ in range(max_iters + 1):
            ra, rb = parent[ea], parent[eb]
            cross = ra != rb
            src = torch.cat([ra[cross], rb[cross]])
            dst = torch.cat([rb[cross], ra[cross]])
            r2 = rank[cross].repeat(2)
            # the segmented min: sort by (component, rank), take run heads
            key, perm = torch.sort(src * n_e + r2)
            comp = key // n_e
            head = torch.ones_like(comp, dtype=torch.bool)
            head[1:] = comp[1:] != comp[:-1]
            comp = comp[head]
            other = dst[perm[head]]
            cw = w_by_rank[(key % n_e)[head]]
            if felz:
                # (w - Int(C)) * |C| <= k on both sides, in float32
                ok = (((cw - intdiff[comp]) * size[comp].float() <= kf)
                      & ((cw - intdiff[other]) * size[other].float() <= kf))
            else:
                ok = size[comp] < min_size
            succ = idx.clone()
            succ[comp[ok]] = other[ok]
            hook_w = torch.full((v,), math.inf, device=dev)
            hook_w[comp[ok]] = cw[ok]
            mutual = (succ[succ] == idx) & (succ != idx)
            succ = torch.where(mutual & (idx < succ), idx, succ)
            used = succ != idx
            if not bool(used.any()):
                break
            root = _pointer_jump(succ)
            new_parent = root[parent]
            is_root = parent == idx
            size = torch.zeros_like(size).index_add_(
                0, new_parent[is_root], size[is_root])
            intdiff = torch.zeros_like(intdiff).scatter_reduce_(
                0, new_parent[is_root], intdiff[is_root], "amax")
            intdiff = intdiff.scatter_reduce_(0, new_parent[used],
                                              hook_w[used], "amax")
            parent = new_parent
        return parent, size, intdiff

    state = (idx.clone(), torch.ones(v, dtype=torch.int64, device=dev),
             torch.zeros(v, dtype=torch.float32, device=dev))
    state = rounds(*state, felz=True)
    if min_size > 1:
        state = rounds(*state, felz=False)
    return state[0].to(torch.int32).reshape(h, w)


def canonical_labels(labels: torch.Tensor) -> torch.Tensor:
    """Each component relabelled by its least flat pixel id (int32): two
    label maps are the same partition iff these are equal."""
    flat = labels.reshape(-1).to(torch.int64)
    uniq, inv = torch.unique(flat, return_inverse=True)
    least = torch.full((uniq.numel(),), flat.numel(), dtype=torch.int64,
                       device=flat.device)
    least = least.scatter_reduce_(0, inv, torch.arange(
        flat.numel(), device=flat.device), "amin")
    return least[inv].to(torch.int32).reshape(labels.shape)

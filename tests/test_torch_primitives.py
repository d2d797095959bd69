"""The port's atomic-path primitives and grid-graph decoders against
`gseg_tpu`'s, on the CPU, with inputs made from a numpy seed.

Every comparison is byte-equal (integer outputs, and float32 outputs that
are mins, maxes or exact copies of their inputs): `pointer_double`,
`component_min_edge` (weights drawn from a few values, so many vertices
tie and phase 2's edge-id rule decides), `remove_mutual_hooks`,
`segment_sum` / `segment_max` with indices out of range (dropped),
`flat_offsets`, `edge_endpoints` (INT32_MAX ids included) and `edge_list`;
the stream compactions `block_compact`, `sparse_select` and
`compact_indices`, at sparse, dense and empty masks, with and without
overflow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gseg_tpu.ops import grid_graph as jgg  # noqa: E402
from gseg_tpu.ops import primitives as jp  # noqa: E402
from gseg_tpu_torch.ops import grid_graph as tgg  # noqa: E402
from gseg_tpu_torch.ops import primitives as tp  # noqa: E402

INT32_MAX = tp.INT32_MAX


def _same(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    assert np.array_equal(ref, got, equal_nan=False)


def _forest(rng, n, depth):
    """A random forest whose chains reach about `depth` steps."""
    parent = np.arange(n, dtype=np.int32)
    order = rng.permutation(n)
    for i in range(1, n):
        j = max(0, i - rng.integers(1, depth + 1))
        if rng.random() < 0.9:
            parent[order[i]] = order[j]
    return parent


@pytest.mark.parametrize("n,depth,max_rounds", [
    (1, 1, None), (97, 3, None), (500, 40, None), (500, 200, 3)])
def test_pointer_double_matches_reference(n, depth, max_rounds):
    rng = np.random.default_rng(n + depth)
    parent = _forest(rng, n, depth)
    ref = jp.pointer_double(jnp.asarray(parent), max_rounds)
    got = tp.pointer_double(torch.from_numpy(parent), max_rounds)
    _same(ref, got)
    if max_rounds is None:  # converged: every pointer is a root
        assert (got[got.long()] == got).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_component_min_edge_tie_rule(seed):
    """Phase 2 picks the smallest edge id among the vertices whose weight
    ties the component's min; vertices without an edge (+inf, INT32_MAX)
    and components with none at all included."""
    rng = np.random.default_rng(seed)
    v, comps = 400, 37
    roots = rng.integers(0, comps, v).astype(np.int32)
    vminw = rng.choice(np.float32([0.5, 1.0, 1.0, 2.0, np.inf]), v)
    veid = rng.permutation(4 * v)[:v].astype(np.int32)
    veid[~np.isfinite(vminw)] = INT32_MAX
    rw, re = jp.component_min_edge(jnp.asarray(roots), jnp.asarray(vminw),
                                   jnp.asarray(veid), v)
    tw, te = tp.component_min_edge(torch.from_numpy(roots),
                                   torch.from_numpy(vminw),
                                   torch.from_numpy(veid), v)
    _same(rw, tw)
    _same(re, te)
    # ties did happen, and the smallest tying id won
    c = int(roots[vminw == 1.0][0])
    tied = (roots == c) & (vminw == float(tw[c]))
    assert tied.sum() > 1 or float(tw[c]) < 1.0
    assert int(te[c]) == veid[tied].min()


def test_remove_mutual_hooks_matches_reference():
    rng = np.random.default_rng(5)
    n = 300
    succ = np.arange(n, dtype=np.int32)
    pairs = rng.permutation(n)[:120].reshape(-1, 2)
    succ[pairs[:, 0]], succ[pairs[:, 1]] = pairs[:, 1], pairs[:, 0]
    rest = rng.permutation(n)[:60]
    succ[rest] = rng.integers(0, n, rest.size)
    _same(jp.remove_mutual_hooks(jnp.asarray(succ)),
          tp.remove_mutual_hooks(torch.from_numpy(succ)))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_segment_sum_and_max_drop_out_of_range(dtype):
    rng = np.random.default_rng(7)
    n, slots = 1000, 50
    vals = rng.integers(0, 1000, n).astype(dtype)
    # in range, past the end (dropped) and negative (counted from the end)
    seg = rng.integers(-5, slots + 5, n).astype(np.int32)
    seg = np.where(seg < -slots, 0, seg).astype(np.int32)
    _same(jp.segment_sum(jnp.asarray(vals), jnp.asarray(seg), slots),
          tp.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg),
                         slots))
    _same(jp.segment_max(jnp.asarray(vals), jnp.asarray(seg), slots, fill=3),
          tp.segment_max(torch.from_numpy(vals), torch.from_numpy(seg),
                         slots, fill=3))


@pytest.mark.parametrize("h,w", [(1, 7), (13, 1), (9, 11)])
def test_edge_endpoints_and_edge_list(h, w):
    assert tgg.flat_offsets(w) == jgg.flat_offsets(w)
    rng = np.random.default_rng(h * w)
    eid = rng.integers(0, 4 * h * w, 200).astype(np.int32)
    eid[::7] = INT32_MAX
    ra, rb = jgg.edge_endpoints(jnp.asarray(eid), w)
    ta, tb = tgg.edge_endpoints(torch.from_numpy(eid), w)
    _same(ra, ta)
    _same(rb, tb)
    weights = rng.uniform(0, 9, (4, h, w)).astype(np.float32)
    valid = np.stack([np.asarray(jgg.valid_plane(h, w, dy, dx))
                      for dy, dx in jgg.DIRS4])
    weights[~valid] = np.inf
    ref = jgg.edge_list(jnp.asarray(weights), jnp.asarray(valid))
    got = tgg.edge_list(torch.from_numpy(weights), torch.from_numpy(valid))
    for r, g in zip(ref, got, strict=True):
        _same(r, g)
    # edge i has canonical id i: its endpoints decode back
    src, dst, _, va = (x.numpy() for x in got)
    ids = np.nonzero(va)[0].astype(np.int32)
    a, b = tgg.edge_endpoints(torch.from_numpy(ids), w)
    assert np.array_equal(a.numpy(), src[ids])
    assert np.array_equal(b.numpy(), dst[ids])


MASKS = [(1000, 0.05, 128), (777, 0.3, 64), (640, 0.9, 256), (50, 0.0, 64)]


def _mask_and_payload(n, p):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < p
    return (mask, rng.integers(-5, 1000, n).astype(np.int32),
            rng.random(n).astype(np.float32))


@pytest.mark.parametrize("n,p,cap", MASKS)
def test_block_compact_matches_reference(n, p, cap):
    mask, a, b = _mask_and_payload(n, p)
    rm, routs, rovf = jp.block_compact(jnp.asarray(mask),
                                       [jnp.asarray(a), jnp.asarray(b)], cap)
    gm, gouts, govf = tp.block_compact(torch.from_numpy(mask),
                                       [torch.from_numpy(a),
                                        torch.from_numpy(b)], cap)
    _same(rm, gm)
    for r, g in zip(routs, gouts, strict=True):
        _same(r, g)
    assert bool(rovf) == bool(govf)


@pytest.mark.parametrize("n,p,cap", MASKS)
def test_sparse_select_and_compact_indices_match_reference(n, p, cap):
    mask, a, b = _mask_and_payload(n, p)
    for c in (cap, 5):  # 5: overflow unless the mask is nearly empty
        rm, routs, rovf = jp.sparse_select(
            jnp.asarray(mask), [jnp.asarray(a), jnp.asarray(b)], c)
        gm, gouts, govf = tp.sparse_select(
            torch.from_numpy(mask), [torch.from_numpy(a),
                                     torch.from_numpy(b)], c)
        _same(rm, gm)
        for r, g in zip(routs, gouts, strict=True):
            _same(r, g)
        assert bool(rovf) == bool(govf)
        ri, rc = jp.compact_indices(jnp.asarray(mask), c)
        gi, gc = tp.compact_indices(torch.from_numpy(mask), c)
        _same(ri, gi)
        _same(rc, gc)

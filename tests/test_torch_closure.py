"""PyTorch port's scan closures and closure-route fixpoints vs references.

- The plain closure functions (one launch's worth: a forward then a
  backward segmented closure along every row or column) against an
  independent NumPy sequential scan, with random asymmetric allow bits and
  reach bits set across the image edges.
- `compmin_gossip`, `label_flood` and `value_flood` with `closures=True`
  against the reference's Pallas hybrid route (`closures=True`) in Mosaic's
  TPU interpret mode, with `WARM_PASSES` set to 0 so its closure kernel
  runs from the first pass. On the CPU the port's wrappers run their plain
  sweeps; the card holds its closure route against the same plain versions
  (tests/test_torch_cuda.py, chip_smoke.py). Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gseg_tpu.ops.pallas import gossip as pg  # noqa: E402
from gseg_tpu_torch.ops import grid_graph as tgg  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402

# the shapes of tests/test_pallas_gossip.py, plus 1-row and 1-column planes.
SHAPES = [(23, 70), (37, 150), (64, 128)]
TINY = [(1, 19), (17, 1)]
INT32_MAX = kg.INT32_MAX


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _fields(h, w, seed):
    rng = np.random.default_rng(seed)
    return dict(
        L=rng.integers(0, 3, (h, w)).astype(np.int32),
        allow=rng.integers(0, 256, (h, w)).astype(np.int32),
        bw=rng.choice(np.float32([0.25, 0.5, 1.0, np.inf]), (h, w)),
        be=rng.integers(0, 50, (h, w)).astype(np.int32),
        sz=rng.integers(1, 9, (h, w)).astype(np.int32),
        Lc=rng.integers(0, 10_000, (h, w)).astype(np.int32),
        idf=rng.uniform(0, 5, (h, w)).astype(np.float32),
    )


def _join_compmin(c, n):
    (cw, ce, cs), (nw, ne, ns) = c, n
    if nw < cw or (nw == cw and ne < ce):
        cw, ce = nw, ne
    return cw, ce, max(cs, ns)


def _join_labelnd(c, n):
    return min(c[0], n[0]), max(c[1], n[1])


def _join_value(c, n):
    return (min(c[0], n[0]),)


def _np_closure(kind, ro, fields, axis, join):
    """Sequential forward then backward scan along each line of `axis`:
    a pixel joins its predecessor (successor) when it takes from it."""
    if axis == 0:
        ro = ro.T
        fields = [f.T for f in fields]
    fields = [f.copy() for f in fields]
    bf, bb = (4, 0) if axis == 1 else (5, 1)
    rows, n = ro.shape

    def takes(r, x, nx, bit):
        if kind == "label":
            return ro[r, x] == ro[r, nx]
        return (int(ro[r, x]) >> bit) & 1 == 1

    for r in range(rows):
        for x in range(1, n):
            if takes(r, x, x - 1, bf):
                new = join(tuple(f[r, x] for f in fields),
                           tuple(f[r, x - 1] for f in fields))
                for f, v in zip(fields, new):
                    f[r, x] = v
        for x in range(n - 2, -1, -1):
            if takes(r, x, x + 1, bb):
                new = join(tuple(f[r, x] for f in fields),
                           tuple(f[r, x + 1] for f in fields))
                for f, v in zip(fields, new):
                    f[r, x] = v
    return [f.T if axis == 0 else f for f in fields]


VARIANTS = {
    "compmin": (kg.compmin_closure_plain, kg.compmin_closure, "label",
                ("bw", "be", "sz"), _join_compmin),
    "labelnd": (kg.labelnd_closure_plain, kg.labelnd_closure, "allow",
                ("Lc", "idf"), _join_labelnd),
    "value": (kg.value_closure_plain, kg.value_closure, "label", ("be",),
              _join_value),
}


@pytest.mark.parametrize("shape", SHAPES + TINY)
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_closure_matches_sequential_scan(variant, axis, shape):
    plain, wrapper, kind, names, join = VARIANTS[variant]
    h, w = shape
    f = _fields(h, w, seed=h * 31 + w + axis)
    ro = f["L"] if kind == "label" else f["allow"]
    want = _np_closure(kind, ro, [f[k] for k in names], axis, join)
    got = plain(_t(ro), *(_t(f[k]) for k in names), axis)
    for a, b in zip(want, got[:-1]):
        assert np.array_equal(a, b.numpy())
    changed = any(not np.array_equal(a, f[k]) for a, k in zip(want, names))
    assert got[-1] is changed
    # on CPU tensors the wrapper is the plain version and launches nothing.
    again = wrapper(_t(ro), *(_t(f[k]) for k in names), axis)
    assert all(torch.equal(a, b) for a, b in zip(again[:-1], got[:-1]))
    assert again[-1] is changed
    assert wrapper.launches == 0 and wrapper.axis_launches == [0, 0]


def test_closure_reaches_a_whole_run_in_one_launch():
    """A row of one label holding its min at the far end: one rows launch
    spreads it over the whole row, one columns launch does nothing."""
    w = 300
    L = torch.zeros((3, w), dtype=torch.int32)
    L[1] = 1
    val = torch.arange(3 * w, dtype=torch.int32).reshape(3, w).flip(1)
    got, changed = kg.value_closure(L, val, 1)
    assert changed and torch.equal(got, val.min(1, keepdim=True).values
                                   .expand(3, w))
    got, changed = kg.value_closure(L, val, 0)
    assert not changed and torch.equal(got, val)


def test_asymmetric_allow_bits_flow_one_way():
    """Allow bit 4 only (flow from the left, set at column 0 too, where it
    reaches nothing): the row's first value sweeps right, and the min at
    the right end of a decreasing row does not flow back left."""
    w = 40
    allow = torch.full((1, w), 1 << 4, dtype=torch.int32)
    idf = torch.zeros((1, w))
    inc = torch.arange(w, dtype=torch.int32)[None].contiguous()
    got, _, changed = kg.labelnd_closure(allow, inc, idf, 1)
    assert changed and int(got.max()) == 0
    dec = inc.flip(1).contiguous()
    got, _, changed = kg.labelnd_closure(allow, dec, idf, 1)
    assert not changed and torch.equal(got, dec)
    got, _, changed = kg.labelnd_closure(allow, dec, idf, 0)
    assert not changed


def test_closure_wrappers_check_arguments():
    z = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="axis"):
        kg.value_closure(z, z, 2)
    with pytest.raises(ValueError, match="compmin"):
        kg.compmin_closure(z, z, z, z, 1)  # bw must be float32


_TORCH_JOINS = {"compmin": kg._compmin_join, "labelnd": kg._labelnd_join,
                "value": kg._value_join}


def _chunked_columns(kind, join, ro, fields, chunk, nchunks):
    """The columns launch's decomposition (csrc/closure.cu, closure_cols)
    in plain torch, vectorised over columns: per sweep (down, then up on
    its results) each of `nchunks` chunks of `chunk` rows (empty ones
    last) scans itself sequentially, a carry scan over the chunks in scan
    order joins a chunk's end value with its predecessor's where every
    pixel of the chunk takes, and each chunk folds its predecessor's value
    into the prefix that the carry reaches."""
    h, w = ro.shape
    assert chunk * nchunks >= h
    f = [x.clone() for x in fields]
    rows = [(min(r * chunk, h), min(r * chunk + chunk, h))
            for r in range(nchunks)]
    for down, takes in zip((True, False), kg._reach(ro, kind, 0)):
        order = rows if down else rows[::-1]
        ys = [list(range(lo, hi)) if down else list(range(hi - 1, lo - 1, -1))
              for lo, hi in order]
        agg, passes = [], []
        for chunk_ys in ys:  # 1. each chunk alone
            if not chunk_ys:
                agg.append(None)
                passes.append(torch.zeros(w, dtype=torch.bool))
                continue
            cur = [x[chunk_ys[0]] for x in f]
            every = takes[chunk_ys[0]].clone()
            for y in chunk_ys[1:]:
                cur = join(cur, [x[y] for x in f], takes[y])
                for x, v in zip(f, cur):
                    x[y] = v
                every &= takes[y]
            agg.append(cur)
            passes.append(every)
        for s in range(1, nchunks):  # 2. the carry scan
            if agg[s] is not None and agg[s - 1] is not None:
                agg[s] = join(agg[s - 1], agg[s], passes[s])
            elif agg[s] is not None:
                assert not passes[s].any()  # a chunk after an empty one
        for s in range(1, nchunks):  # 3. the fold
            if agg[s - 1] is None:
                continue
            reach = torch.ones(w, dtype=torch.bool)
            for y in ys[s]:
                reach &= takes[y]
                new = join(agg[s - 1], [x[y] for x in f], reach)
                for x, v in zip(f, new):
                    x[y] = v
    return f


def _boundary_columns(h, chunk, rng):
    """Labels whose runs start, end and span exactly at chunk boundaries
    and one row off them, a column of one label, one with no run, and
    random runs; (h, 11) int32."""
    y = np.arange(h)
    cols = [np.zeros(h), y % 2, y // chunk, (y + 1) // chunk,
            (y + chunk - 1) // chunk, y // (2 * chunk),
            (y + chunk // 2) // (3 * chunk)]
    for _ in range(4):
        cols.append(np.cumsum(rng.random(h) < 0.2) % 3)
    return np.stack(cols, 1).astype(np.int32)


@pytest.mark.parametrize("chunk", [1, 3, 7, 64])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_chunked_columns_decomposition_equals_plain(variant, chunk):
    """The columns kernel's three-phase decomposition gives the plain
    closure's bits on axis 0, at heights below one chunk, at one chunk, one
    row past it and across many, with two empty chunks past the image as
    the kernel has when its chunks outrun h."""
    plain, _, kind, names, _ = VARIANTS[variant]
    rng = np.random.default_rng(chunk)
    for h in sorted({1, max(chunk - 1, 1), chunk, chunk + 1, 3 * chunk,
                     5 * chunk + 2}):
        L = _boundary_columns(h, chunk, rng)
        f = _fields(h, L.shape[1], seed=h + chunk)
        if kind == "label":
            ro = _t(L)
        else:  # same-label links both ways plus random one-way links
            same = np.zeros_like(L, dtype=bool)
            same[1:] = L[1:] == L[:-1]
            up = same | (rng.random(L.shape) < 0.1)
            down = np.roll(same, -1, 0) | (rng.random(L.shape) < 0.1)
            ro = _t(f["allow"] & ~0x22 | up << 5 | down << 1)
        fields = [_t(f[k]) for k in names]
        want = plain(ro, *fields, 0)[:-1]
        got = _chunked_columns(kind, _TORCH_JOINS[variant], ro, fields,
                               chunk, -(-h // chunk) + 2)
        for a, b in zip(want, got):
            assert torch.equal(a, b), (h, chunk)


def _assert_equal(ref, got):
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())


def _allow_bits(L, rng):
    """Same-label links plus random one-way links, none across the image
    edges (the producer's guarantee, gossip.py:1235-1238)."""
    h, w = L.shape
    Lt = _t(L)
    bits = torch.zeros((h, w), dtype=torch.int32)
    extra = rng.random((8, h, w)) < 0.15
    for d, (dy, dx) in enumerate(tgg.DIRS8):
        same = tgg.shift_plane(Lt, dy, dx, -1) == Lt
        ok = same | (_t(extra[d]) & tgg.valid_plane(h, w, dy, dx))
        bits |= ok.to(torch.int32) << d
    return bits.numpy()


def test_compmin_closures_match_pallas(monkeypatch):
    monkeypatch.setattr(pg, "WARM_PASSES", 0)
    for h, w in SHAPES:
        f = _fields(h, w, seed=h + w)
        f["bw"] = np.random.default_rng(h).uniform(0, 1, (h, w)).astype(
            np.float32)
        ms = 4 * (h + w)
        with pltpu.force_tpu_interpret_mode():
            ref = pg.compmin_gossip(*(jnp.asarray(f[k]) for k in
                                      ("L", "bw", "be", "sz")), ms,
                                    closures=True)
        got = kg.compmin_gossip(*(_t(f[k]) for k in ("L", "bw", "be", "sz")),
                                ms, closures=True)
        _assert_equal(ref[:3], got[:3])
        assert bool(ref[3]) is False and got[3] is False
        assert int(ref[4]) > 0  # closure pass pairs ran


def test_floods_closures_match_pallas(monkeypatch):
    monkeypatch.setattr(pg, "WARM_PASSES", 0)
    for h, w in SHAPES:
        f = _fields(h, w, seed=3 * h + w)
        allow = _allow_bits(f["L"], np.random.default_rng(w))
        ms = 4 * (h + w)
        with pltpu.force_tpu_interpret_mode():
            rL, rI, r_unconv, r_pairs = pg.label_flood(
                jnp.asarray(allow), jnp.asarray(f["Lc"]),
                jnp.asarray(f["idf"]), ms, closures=True)
            rv, rv_unconv, rv_pairs = pg.value_flood(
                jnp.asarray(f["L"]), jnp.asarray(f["Lc"]), ms,
                closures=True)
        gL, gI, g_unconv = kg.label_flood(_t(allow), _t(f["Lc"]),
                                          _t(f["idf"]), ms, closures=True)
        _assert_equal((rL, rI), (gL, gI))
        assert bool(r_unconv) is False and g_unconv is False
        gv, gv_unconv = kg.value_flood(_t(f["L"]), _t(f["Lc"]), ms,
                                       closures=True)
        _assert_equal((rv,), (gv,))
        assert bool(rv_unconv) is False and gv_unconv is False
        assert int(r_pairs) > 0 and int(rv_pairs) > 0

"""PyTorch port's step fixpoints vs the JAX reference's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference runs `gseg_tpu.ops.pallas.gossip` step-only (closures=False) in
Mosaic's TPU interpret mode, as its own tests do. Every comparison is
exact: labels and integer fields, and float fields that are only selected
by min/max, are bit-equal. The CUDA kernels themselves run on the card
(`python3 chip_smoke.py`), where they are held against the same plain
versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import gseg_tpu.ops.grid_graph as jgg  # noqa: E402
from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
from gseg_tpu.ops.pallas import gossip as pg  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402
from gseg_tpu_torch.ops.kernels import pad as kp  # noqa: E402

# the shapes of tests/test_pallas_gossip.py: not multiples of 8/128.
SHAPES = [(23, 70), (37, 150), (64, 128)]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _fields(h, w, seed, ncomp=7):
    rng = np.random.default_rng(seed)
    return dict(
        L=rng.integers(0, ncomp, (h, w)).astype(np.int32),
        bw=rng.uniform(0, 1, (h, w)).astype(np.float32),
        be=rng.integers(0, 10_000, (h, w)).astype(np.int32),
        sz=rng.integers(1, 9, (h, w)).astype(np.int32),
        idf=rng.uniform(0, 5, (h, w)).astype(np.float32),
        mark4=rng.integers(0, 2, (4, h, w)).astype(bool),
    )


def _allow8(L, mark4):
    """Same-label | merge-mark adjacency, both directions, as _ground builds
    it (marks never point out of the image)."""
    h, w = L.shape
    mark4 = mark4.copy()
    for d, (dy, dx) in enumerate(jgg.DIRS4):
        mark4[d] &= np.asarray(jgg.valid_plane(h, w, dy, dx))
    Lj = jnp.asarray(L)
    allow = []
    for d, (dy, dx) in enumerate(jgg.DIRS8):
        if d < 4:
            am = jnp.asarray(mark4[d])
        else:
            ddy, ddx = jgg.DIRS4[d - 4]
            am = jgg.shift_plane(jnp.asarray(mark4[d - 4]), -ddy, -ddx, False)
        allow.append((jgg.shift_plane(Lj, dy, dx, -1) == Lj) | am)
    return allow


def _assert_equal(ref, got):
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())


def _launches():
    return [fn.launches for fn in (*kg._WRAPPERS.values(),
                                   kp.fast_pad_fields, kp.fast_unpad_fields)]


@pytest.fixture(autouse=True)
def _no_kernel_launches_on_cpu():
    before = _launches()
    yield
    assert _launches() == before == [0] * len(before)


@pytest.mark.parametrize("shape", SHAPES)
def test_compmin_matches_pallas(shape):
    h, w = shape
    f = _fields(h, w, seed=h * 1000 + w)
    ms = 4 * (h + w)
    with pltpu.force_tpu_interpret_mode():
        ref = pg.compmin_gossip(*(jnp.asarray(f[k]) for k in
                                  ("L", "bw", "be", "sz")), ms,
                                closures=False)
    got = kg.compmin_gossip(*(_t(f[k]) for k in ("L", "bw", "be", "sz")), ms)
    _assert_equal(ref[:3], got[:3])
    assert bool(ref[3]) is False and got[3] is False


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_label_flood_matches_pallas(shape):
    h, w = shape
    f = _fields(h, w, seed=3 * h + w, ncomp=6)
    allow = _allow8(f["L"], f["mark4"])
    ms = 4 * (h + w)
    with pltpu.force_tpu_interpret_mode():
        rL, rI, r_unconv, _ = pg.label_flood(
            pg.pack_allow_bits(allow), jnp.asarray(f["L"]),
            jnp.asarray(f["idf"]), ms, closures=False)
    bits = kg.pack_allow_bits([_t(np.asarray(a)) for a in allow])
    assert np.array_equal(np.asarray(pg.pack_allow_bits(allow)),
                          bits.numpy())
    gL, gI, g_unconv = kg.label_flood(bits, _t(f["L"]), _t(f["idf"]), ms)
    _assert_equal((rL, rI), (gL, gI))
    assert bool(r_unconv) is False and g_unconv is False


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_value_flood_matches_pallas(shape):
    h, w = shape
    f = _fields(h, w, seed=5 * h + w, ncomp=4)
    ms = 4 * (h + w)
    with pltpu.force_tpu_interpret_mode():
        ref, r_unconv, _ = pg.value_flood(jnp.asarray(f["L"]),
                                          jnp.asarray(f["be"]), ms,
                                          closures=False)
    got, g_unconv = kg.value_flood(_t(f["L"]), _t(f["be"]), ms)
    _assert_equal((ref,), (got,))
    assert bool(r_unconv) is False and g_unconv is False


def test_multistrip_fixpoints_match_pallas(monkeypatch):
    """The reference forced multi-strip (8-row strips) on thin, tall
    components whose labels decrease with depth: the shape of the round-3
    wrapped-halo leak. The port must reach the same fixpoints."""
    monkeypatch.setenv("GSEG_SKIP_ROWS", "8")
    h, w = 48, 40
    comp = (np.arange(w)[None, :] // 3) * 2 + (np.arange(h)[:, None] >= 30)
    L = np.broadcast_to(comp, (h, w)).astype(np.int32)
    rng = np.random.default_rng(7)
    idf = rng.uniform(0, 5, (h, w)).astype(np.float32)
    Lc0 = ((h - np.arange(h))[:, None] * 1000
           + np.arange(w)[None, :]).astype(np.int32)
    ms = 4 * (h + w)
    allow = _allow8(L, np.zeros((4, h, w), bool))
    bw = rng.uniform(0, 1, (h, w)).astype(np.float32)
    be = rng.integers(0, 10_000, (h, w)).astype(np.int32)
    sz = rng.integers(1, 9, (h, w)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        rL, rI, _, _ = pg.label_flood(pg.pack_allow_bits(allow),
                                      jnp.asarray(Lc0), jnp.asarray(idf), ms,
                                      closures=False)
        rc = pg.compmin_gossip(jnp.asarray(L), jnp.asarray(bw),
                               jnp.asarray(be), jnp.asarray(sz), ms,
                               closures=False)
        rv, _, _ = pg.value_flood(jnp.asarray(L), jnp.asarray(Lc0), ms,
                                  closures=False)
    bits = kg.pack_allow_bits([_t(np.asarray(a)) for a in allow])
    gL, gI, _ = kg.label_flood(bits, _t(Lc0), _t(idf), ms)
    _assert_equal((rL, rI), (gL, gI))
    gc = kg.compmin_gossip(_t(L), _t(bw), _t(be), _t(sz), ms)
    _assert_equal(rc[:3], gc[:3])
    gv, _ = kg.value_flood(_t(L), _t(Lc0), ms)
    _assert_equal((rv,), (gv,))


def test_compmin_idle_returns_inputs():
    """idle=True (round 1, all-singleton labels): the reference runs zero
    passes and returns its inputs; so does the port, without computing."""
    h, w = 23, 70
    f = _fields(h, w, seed=1)
    L = np.arange(h * w, dtype=np.int32).reshape(h, w)
    ms = 4 * (h + w)
    with pltpu.force_tpu_interpret_mode():
        ref = pg.compmin_gossip(jnp.asarray(L), jnp.asarray(f["bw"]),
                                jnp.asarray(f["be"]), jnp.asarray(f["sz"]),
                                ms, closures=False, idle=jnp.bool_(True))
    args = (_t(f["bw"]), _t(f["be"]), _t(f["sz"]))
    got = kg.compmin_gossip(_t(L), *args, ms, idle=True)
    _assert_equal(ref[:3], got[:3])
    assert int(ref[4]) == 0 and got[3] is False
    assert all(g is a for g, a in zip(got[:3], args))


def test_unconverged_is_flagged():
    """A sweep cap below the component diameter ends the loop unconverged,
    and the wrapper reports it."""
    h, w = 1, 40
    L = np.zeros((h, w), np.int32)
    val = np.arange(w, dtype=np.int32)[::-1].copy().reshape(h, w)
    _, unconv = kg.value_flood(_t(L), _t(val), 5)
    assert unconv is True
    got, unconv = kg.value_flood(_t(L), _t(val), 4 * (h + w))
    assert unconv is False and int(got.max()) == 0


def test_wrappers_check_types_on_every_device():
    """The kernel's dtype contract is checked before the CPU routing, so a
    caller handing an int64 dist fails here as it would on the card."""
    z = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="labeldist"):
        kg.label_gossip(z, z, z.float(), z.long(), 32)
    with pytest.raises(ValueError, match="subsum"):
        kg.subtree_sums(z, z.float(), 32)


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """No quiet move: a tensor that is neither on the CPU nor on a CUDA
    device is refused rather than copied."""
    L = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kg.value_flood(L, torch.zeros((4, 4), dtype=torch.int32,
                                      device="meta"), 32)
    with pytest.raises(ValueError):
        kg.value_flood(torch.zeros((4, 4), dtype=torch.int32), L, 32)


def _dist_seeds(rng, h, w):
    """Sparse BFS seeds (0) among unreached pixels (BIGDIST)."""
    return np.where(rng.random((h, w)) < 0.05, 0, kg.BIGDIST).astype(
        np.int32)


@pytest.mark.parametrize("shape", SHAPES)
def test_label_gossip_matches_pallas(shape):
    h, w = shape
    f = _fields(h, w, seed=11 * h + w, ncomp=6)
    allow = _allow8(f["L"], f["mark4"])
    dist0 = _dist_seeds(np.random.default_rng(h + w), h, w)
    ms = 4 * (h + w)
    with pltpu.force_tpu_interpret_mode():
        ref = pg.label_gossip(pg.pack_allow_bits(allow), jnp.asarray(f["L"]),
                              jnp.asarray(f["idf"]), jnp.asarray(dist0), ms)
    bits = kg.pack_allow_bits([_t(np.asarray(a)) for a in allow])
    got = kg.label_gossip(bits, _t(f["L"]), _t(f["idf"]), _t(dist0), ms)
    _assert_equal(ref[:3], got[:3])
    assert bool(ref[3]) is False and got[3] is False


def test_multistrip_label_gossip_matches_pallas(monkeypatch):
    """Thin, tall components whose labels decrease with depth, with the
    reference forced to 8-row strips: the dist must ride the same
    multi-strip fixpoint as the labels."""
    monkeypatch.setenv("GSEG_SKIP_ROWS", "8")
    h, w = 48, 40
    comp = (np.arange(w)[None, :] // 3) * 2 + (np.arange(h)[:, None] >= 30)
    L = np.broadcast_to(comp, (h, w)).astype(np.int32)
    rng = np.random.default_rng(8)
    idf = rng.uniform(0, 5, (h, w)).astype(np.float32)
    Lc0 = ((h - np.arange(h))[:, None] * 1000
           + np.arange(w)[None, :]).astype(np.int32)
    dist0 = _dist_seeds(rng, h, w)
    ms = 4 * (h + w)
    allow = _allow8(L, np.zeros((4, h, w), bool))
    with pltpu.force_tpu_interpret_mode():
        ref = pg.label_gossip(pg.pack_allow_bits(allow), jnp.asarray(Lc0),
                              jnp.asarray(idf), jnp.asarray(dist0), ms)
    bits = kg.pack_allow_bits([_t(np.asarray(a)) for a in allow])
    got = kg.label_gossip(bits, _t(Lc0), _t(idf), _t(dist0), ms)
    _assert_equal(ref[:3], got[:3])
    assert bool(ref[3]) is False and got[3] is False


def _bfs_pdir(L):
    """Canonical labels, BFS levels from each root over same-label
    adjacency (the riding-dist flood with no adoption), and the parent
    directions `_subtree_sizes` derives from them."""
    h, w = L.shape
    vid = np.arange(h * w, dtype=np.int32).reshape(h, w)
    Lj = jnp.asarray(L)
    allow = [jgg.shift_plane(Lj, dy, dx, -1) == Lj for dy, dx in jgg.DIRS8]
    dist0 = np.where(L == vid, 0, kg.BIGDIST).astype(np.int32)
    _, _, dist, unconv = kg.label_gossip_plain(
        kg.pack_allow_bits([_t(np.asarray(a)) for a in allow]), _t(L),
        torch.zeros((h, w)), _t(dist0), 4 * (h + w))
    assert unconv is False
    nL = [jgg.shift_plane(Lj, dy, dx, -1) for dy, dx in jgg.DIRS8]
    dj = jnp.asarray(dist.numpy())
    nd = [jgg.shift_plane(dj, dy, dx, kg.BIGDIST) for dy, dx in jgg.DIRS8]
    pdir = jnp.full((h, w), 8, jnp.int32)
    for d in range(7, -1, -1):
        ok = (nL[d] == Lj) & (nd[d] == dj - 1) & (dj > 0) \
            & (dj < kg.BIGDIST)
        pdir = jnp.where(ok, jnp.int32(d), pdir)
    return dist.numpy(), np.asarray(pdir)


def _canonical(L):
    """Relabel the 8-connected same-value regions of L to their min flat
    id (components, not just classes)."""
    h, w = L.shape
    lab = np.arange(h * w, dtype=np.int32).reshape(h, w)
    while True:
        prev = lab.copy()
        for dy, dx in jgg.DIRS8:
            same = np.asarray(jgg.shift_plane(jnp.asarray(L), dy, dx, -1)) \
                == L
            nb = np.asarray(jgg.shift_plane(jnp.asarray(lab), dy, dx, 0))
            lab = np.where(same, np.minimum(lab, nb), lab)
        if np.array_equal(lab, prev):
            return lab


# random partitions at the gossip shapes, plus one component 130 rows tall
# rooted at pixel 0: a parent tree 129 levels (over four 32-pixel tiles)
# deep.
SUBSUM_CASES = [(23, 70, 4), (37, 150, 4), (130, 20, 1)]


@pytest.mark.parametrize("case", SUBSUM_CASES)
def test_subtree_sums_match_pallas(case, monkeypatch):
    h, w, ncomp = case
    rng = np.random.default_rng(h * 13 + w)
    L = _canonical(rng.integers(0, ncomp, (h, w)).astype(np.int32))
    dist, pdir = _bfs_pdir(L)
    ms = 4 * (h + w)
    s0 = np.ones((h, w), np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref_s, ref_unconv = pg.subtree_sums(jnp.asarray(pdir),
                                            jnp.asarray(s0), ms)
    got_s, got_unconv = kg.subtree_sums(_t(pdir), _t(s0), ms)
    _assert_equal((ref_s,), (got_s,))
    assert bool(ref_unconv) is False and got_unconv is False
    # the port's _subtree_sizes (its own parent directions) vs the
    # reference's, Pallas path forced on.
    monkeypatch.setattr(ref_turbo, "_use_pallas", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        ref_sz, ref_unconv = ref_turbo._subtree_sizes(
            jnp.asarray(L), jnp.asarray(dist), ms)
    got_sz, got_unconv = turbo._subtree_sizes(_t(L), _t(dist), ms)
    _assert_equal((ref_sz,), (got_sz,))
    assert bool(ref_unconv) is False and got_unconv is False
    for root in np.unique(L):
        assert got_sz.reshape(-1)[root] == int((L == root).sum())
    if ncomp == 1:
        assert int(dist.max()) == h - 1 > 3 * 32


# (h, w, t, hp, wp): the first two meet the Pallas DMA path's tiling
# (t % 8, h % 8, w == wp); the others take the reference's XLA pad.
PAD_CASES = [(24, 128, 8, 32, 128), (16, 256, 16, 40, 256),
             (23, 70, 8, 32, 128), (5, 3, 8, 32, 128)]


@pytest.mark.parametrize("case", PAD_CASES)
def test_pad_unpad_match_pallas(case):
    h, w, t, hp, wp = case
    rng = np.random.default_rng(h * w)
    fields = [(rng.integers(-9, 9, (h, w)).astype(np.int32), -1),
              (rng.uniform(0, 1, (h, w)).astype(np.float32), float("inf")),
              (rng.integers(0, 99, (h, w)).astype(np.int32), kg.INT32_MAX),
              (rng.uniform(0, 1, (h, w)).astype(np.float32), 0.0)]
    with pltpu.force_tpu_interpret_mode():
        ref = pg._fast_pad_fields([(jnp.asarray(x), f) for x, f in fields],
                                  t, hp, wp)
        ref_back = pg._fast_unpad_fields(ref, t, h, w)
    got = kp.fast_pad_fields([(_t(x), f) for x, f in fields], t, hp, wp)
    for r, g in zip(ref, got):
        assert g.shape == (hp + 2 * t, wp) and g.dtype == _t(r).dtype
    _assert_equal(ref, got)
    back = kp.fast_unpad_fields(got, t, h, w)
    _assert_equal(ref_back, back)
    _assert_equal([x for x, _ in fields], back)

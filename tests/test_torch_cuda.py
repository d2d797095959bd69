"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one; run them on the
card with `python -m pytest --noconftest tests/test_torch_cuda.py -q`
(`--noconftest`: tests/conftest.py imports jax, which that machine lacks).
They import no jax: the references are the port's own plain PyTorch
versions (held against the JAX package by the other tests/test_torch_*.py
files) and its CPU run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops import filters  # noqa: E402
from gseg_tpu_torch.ops import grid_graph as gg  # noqa: E402
from gseg_tpu_torch.ops.kernels import extract as kx  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402
from gseg_tpu_torch.ops.kernels import pad as kp  # noqa: E402
from gseg_tpu_torch.ops.kernels import runs as kr  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

pytestmark = pytest.mark.cuda

# below, at and across the 32x32 tile of csrc/gossip.cu; 1-row and 1-column
# images included.
SHAPES = [(1, 37), (37, 1), (5, 3), (23, 70), (32, 32), (33, 65), (96, 56)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


def _fields(h, w, dev, seed, ncomp):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(x).to(dev)

    return dict(
        L=t(rng.integers(0, ncomp, (h, w)).astype(np.int32)),
        bw=t(rng.uniform(0, 1, (h, w)).astype(np.float32)),
        be=t(rng.integers(0, 10_000, (h, w)).astype(np.int32)),
        sz=t(rng.integers(1, 9, (h, w)).astype(np.int32)),
        allow=t(rng.integers(0, 256, (h, w)).astype(np.int32)),
    )


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ncomp", [1, 3, 50])
def test_fixpoint_kernels_equal_plain(dev, shape, ncomp):
    h, w = shape
    f = _fields(h, w, dev, seed=h * 100 + w + ncomp, ncomp=ncomp)
    ms = 4 * (h + w)
    n0 = (kg.compmin_gossip.launches, kg.label_flood.launches,
          kg.value_flood.launches)
    got = kg.compmin_gossip(f["L"], f["bw"], f["be"], f["sz"], ms)
    ref = kg.compmin_gossip_plain(f["L"], f["bw"], f["be"], f["sz"], ms)
    assert _equal(got[:3], ref[:3]) and got[3] is ref[3] is False
    got = kg.label_flood(f["allow"], f["be"], f["bw"], ms)
    ref = kg.label_flood_plain(f["allow"], f["be"], f["bw"], ms)
    assert _equal(got[:2], ref[:2]) and got[2] is ref[2] is False
    got = kg.value_flood(f["L"], f["be"], ms)
    ref = kg.value_flood_plain(f["L"], f["be"], ms)
    assert torch.equal(got[0], ref[0]) and got[1] is ref[1] is False
    n1 = (kg.compmin_gossip.launches, kg.label_flood.launches,
          kg.value_flood.launches)
    assert all(b > a for a, b in zip(n0, n1))


def _dist_and_pdir(L, seed):
    """BFS levels from sparse random seeds over same-label adjacency, and
    the parent directions of that forest (a consistent, acyclic pdir)."""
    h, w = L.shape
    rng = np.random.default_rng(seed)
    dist0 = torch.from_numpy(np.where(rng.random((h, w)) < 0.05, 0,
                                      kg.BIGDIST).astype(np.int32))
    same = kg.pack_allow_bits([gg.shift_plane(L, dy, dx, -1) == L
                               for dy, dx in gg.DIRS8])
    _, _, dist, unconv = kg.label_gossip_plain(
        same, L, torch.zeros(L.shape, device=L.device),
        dist0.to(L.device), 4 * (h + w))
    assert unconv is False
    return dist0.to(L.device), turbo._parent_dirs(L, dist)


def _new_fixpoints_equal_plain(f, dist0, pdir, ms):
    """label_gossip and subtree_sums, kernel vs plain; returns True."""
    args = (f["allow"], f["be"], f["bw"], dist0, ms)
    got, ref = kg.label_gossip(*args), kg.label_gossip_plain(*args)
    assert _equal(got[:3], ref[:3]) and got[3] is ref[3] is False
    s0 = torch.ones_like(pdir)
    got = kg.subtree_sums(pdir, s0, ms)
    ref = kg.subtree_sums_plain(pdir, s0, ms)
    assert torch.equal(got[0], ref[0]) and got[1] is ref[1] is False
    return True


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ncomp", [1, 3, 50])
def test_labeldist_and_subsum_kernels_equal_plain(dev, shape, ncomp):
    h, w = shape
    f = _fields(h, w, dev, seed=h * 100 + w + ncomp, ncomp=ncomp)
    dist0, pdir = _dist_and_pdir(f["L"], seed=h + w)
    n0 = (kg.label_gossip.launches, kg.subtree_sums.launches)
    assert _new_fixpoints_equal_plain(f, dist0, pdir, 4 * (h + w))
    n1 = (kg.label_gossip.launches, kg.subtree_sums.launches)
    assert all(b > a for a, b in zip(n0, n1))


def test_subsum_kernel_deep_tree(dev):
    """One component 300 rows tall rooted at pixel 0: a 299-level parent
    tree across ten tiles."""
    h, w = 300, 40
    L = torch.zeros((h, w), dtype=torch.int32, device=dev)
    vid = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w)
    dist0 = torch.full_like(L, kg.BIGDIST).masked_fill(L == vid, 0)
    _, _, dist, _ = kg.label_gossip(
        kg.pack_allow_bits([gg.shift_plane(L, dy, dx, -1) == L
                            for dy, dx in gg.DIRS8]),
        L, torch.zeros((h, w), device=dev), dist0, 4 * (h + w))
    assert int(dist.max()) == h - 1
    sizes, unconv = turbo._subtree_sizes(L, dist, 4 * (h + w))
    assert unconv is False and int(sizes[0, 0]) == h * w
    ref, _ = kg.subtree_sums_plain(turbo._parent_dirs(L, dist),
                                   torch.ones_like(L), 4 * (h + w))
    assert torch.equal(sizes, ref)


# the tile shapes, then wide ones: ragged widths (w % 4 != 0: csrc/pad.cu's
# register route), aligned widths with wp > w, 4K and 8K (the bulk route).
PAD_SHAPES = SHAPES + [(37, 2563), (1081, 2599), (37, 2600), (2160, 3840),
                       (4320, 7680)]
# t -> fills of the four planes (int32, float32, int32, int32)
PAD_FILLS = {8: (-1, float("inf"), kg.INT32_MAX, 0),
             0: (8, 0.0, kg.BIGDIST, 0)}


def _offset(x):
    """A contiguous copy of x starting one word past a 16-byte boundary
    (the register route for any width)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("shape", PAD_SHAPES)
def test_pad_kernels_equal_plain(dev, shape):
    h, w = shape
    hp, wp = -(-h // 32) * 32, -(-w // 128) * 128
    f = _fields(h, w, dev, seed=h + 7 * w, ncomp=5)
    planes = [f["L"], f["bw"], f["be"], f["allow"]]
    n0 = (kp.fast_pad_fields.launches, kp.fast_unpad_fields.launches)
    for t, fills in PAD_FILLS.items():
        for k in (1, 2, 3, 4):
            fields = list(zip(planes[:k], fills[:k]))
            got = kp.fast_pad_fields(fields, t, hp, wp)
            assert _equal(got, kp.fast_pad_fields_plain(fields, t, hp, wp))
            back = kp.fast_unpad_fields(got, t, h, w)
            assert _equal(back, kp.fast_unpad_fields_plain(got, t, h, w))
            assert _equal(back, planes[:k])
    # the register route on planes of any width
    fields = [(_offset(x), fill) for x, fill in zip(planes, PAD_FILLS[8])]
    got = kp.fast_pad_fields(fields, 8, hp, wp)
    assert _equal(got, kp.fast_pad_fields_plain(fields, 8, hp, wp))
    back = kp.fast_unpad_fields([_offset(x) for x in got], 8, h, w)
    assert _equal(back, planes)
    n1 = (kp.fast_pad_fields.launches, kp.fast_unpad_fields.launches)
    assert n1 == (n0[0] + 9, n0[1] + 9)


@pytest.mark.parametrize("shape", [(37, 2600), (160, 3840)])
def test_padded_route_equals_plain(dev, shape):
    """At w >= PAD_MIN_WIDTH every fixpoint runs on padded planes: one pad
    and one unpad launch per call, results equal to the plain versions."""
    h, w = shape
    assert w >= kg.PAD_MIN_WIDTH
    f = _fields(h, w, dev, seed=h + w, ncomp=40)
    ms = 4 * (h + w)
    dist0, pdir = _dist_and_pdir(f["L"], seed=w)
    n0 = (kp.fast_pad_fields.launches, kp.fast_unpad_fields.launches)
    got = kg.compmin_gossip(f["L"], f["bw"], f["be"], f["sz"], ms)
    ref = kg.compmin_gossip_plain(f["L"], f["bw"], f["be"], f["sz"], ms)
    assert _equal(got[:3], ref[:3]) and got[3] is ref[3] is False
    got = kg.label_flood(f["allow"], f["be"], f["bw"], ms)
    ref = kg.label_flood_plain(f["allow"], f["be"], f["bw"], ms)
    assert _equal(got[:2], ref[:2]) and got[2] is ref[2] is False
    got = kg.value_flood(f["L"], f["be"], ms)
    ref = kg.value_flood_plain(f["L"], f["be"], ms)
    assert torch.equal(got[0], ref[0]) and got[1] is ref[1] is False
    assert _new_fixpoints_equal_plain(f, dist0, pdir, ms)
    n1 = (kp.fast_pad_fields.launches, kp.fast_unpad_fields.launches)
    assert n1 == (n0[0] + 5, n0[1] + 5)


def test_segment_runs_on_the_card_by_default(dev):
    img = blobs_image(24, 32, 5, 6.0, 0)
    labels = gseg_tpu_torch.segment(img, k=100.0, min_size=8,
                                    algorithm="turbo")
    assert labels.device == torch.device("cuda", 0)
    cpu = gseg_tpu_torch.segment(img, k=100.0, min_size=8, algorithm="turbo",
                                 device="cpu")
    assert torch.equal(labels.cpu(), cpu)


def test_fixpoint_kernel_pass_cap_flags_unconverged(dev):
    """A chain longer than the pass cap allows ends unconverged."""
    w = 200
    L = torch.zeros((1, w), dtype=torch.int32, device=dev)
    val = torch.arange(w, dtype=torch.int32, device=dev).flip(0)[None]
    _, unconv = kg.value_flood(L, val, 16)
    assert unconv is True
    got, unconv = kg.value_flood(L, val, 4 * (1 + w))
    assert unconv is False and int(got.max()) == 0


def _pool(res):
    lo, hi, wv, eid, count, ovf = res
    n = int(count)
    keys = torch.stack([x[:n].double() for x in (lo, hi, wv, eid)], 1)
    keys = keys.cpu().numpy()
    return keys[np.lexsort(keys.T[::-1])], bool(ovf), n


@pytest.mark.parametrize("shape", SHAPES)
def test_extract_kernel_equals_plain(dev, shape):
    h, w = shape
    rng = np.random.default_rng(h * 7 + w)
    L = torch.from_numpy(rng.integers(0, 3, (h, w)).astype(np.int32)).to(dev)
    weights = rng.choice(np.float32([0.5, 1.0, 2.0, 3.5]), (4, h, w))
    for d, (dy, dx) in enumerate(gg.DIRS4):
        weights[d][~gg.valid_plane(h, w, dy, dx).numpy()] = np.inf
    weights = torch.from_numpy(weights).to(dev)
    n0 = kx.boundary_extract.launches
    for cap in (4 * h * w, 7):
        got = _pool(kx.boundary_extract(L, weights, cap))
        ref = _pool(kx.boundary_extract_plain(L, weights, cap))
        assert got[1:] == ref[1:]
        if not got[1]:
            assert np.array_equal(got[0], ref[0])
    assert kx.boundary_extract.launches == n0 + 2


def _striped(h, w, rng):
    """Labels in horizontal stripes 3 rows high with a few breaks: the
    S, SE and NE edges between two stripes form runs across whole rows,
    over every thread, warp (256 pixels) and 2048-pixel tile of the
    kernel's row walk."""
    L = np.repeat(np.arange(h) // 3, w).reshape(h, w)
    breaks = rng.random((h, w)) < 0.002
    return (L + breaks * 1000 * np.arange(1, w + 1)).astype(np.int32)


@pytest.mark.parametrize("shape", [(7, 1000), (50, 1919), (301, 3840)])
def test_extract_kernel_runs_across_tiles_and_caps(dev, shape):
    """Runs crossing the row walk's warps and tiles give one entry each with
    the run's lexmin; at caps 0, 1, count - 1 and count the count and the
    overflow flag are exact, and the filled slots are entries of the full
    pool."""
    h, w = shape
    rng = np.random.default_rng(h + w)
    L = torch.from_numpy(_striped(h, w, rng)).to(dev)
    weights = rng.uniform(0.5, 9.0, (4, h, w)).astype(np.float32)
    for d, (dy, dx) in enumerate(gg.DIRS4):
        weights[d][~gg.valid_plane(h, w, dy, dx).numpy()] = np.inf
    weights = torch.from_numpy(weights).to(dev)
    full, _, count = _pool(kx.boundary_extract_plain(L, weights, 4 * h * w))
    assert count > 1
    got = _pool(kx.boundary_extract(L, weights, 4 * h * w))
    assert got[1:] == (False, count) and np.array_equal(got[0], full)
    entries = {tuple(r) for r in full}
    assert len(entries) == count  # eids are unique
    for cap in (0, 1, count - 1, count):
        lo, hi, wv, eid, n, ovf = kx.boundary_extract(L, weights, cap)
        assert int(n) == count and bool(ovf) is (count > cap)
        filled = torch.stack([x.double() for x in (lo, hi, wv, eid)], 1)
        rows = {tuple(r) for r in filled.cpu().numpy()}
        assert len(rows) == cap and rows <= entries


def test_wrappers_refuse_mixed_devices(dev):
    L = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kg.value_flood(L, torch.zeros((4, 4), dtype=torch.int32), 32)
    with pytest.raises(ValueError):
        kx.boundary_extract(L, torch.zeros((4, 4, 4)), 64)


@pytest.mark.parametrize("case", [
    dict(h=24, w=32, k=100.0, min_size=8, connectivity=8, seed=0),
    dict(h=16, w=16, k=50.0, min_size=1, connectivity=4, seed=2),
    dict(h=1, w=37, k=100.0, min_size=5, connectivity=8, seed=3),
    dict(h=96, w=56, k=200.0, min_size=20, connectivity=8, seed=11),
])
def test_turbo_on_card_equals_cpu(dev, case):
    """The whole path on the card gives the CPU run's labels and flags,
    both fed the same weight planes."""
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"],
                             connectivity=case["connectivity"])
    img = torch.from_numpy(blobs_image(case["h"], case["w"], 6, 6.0,
                                       case["seed"]))
    cpu_labels, cpu_flags = turbo.segment_turbo_impl(img, cfg, 2)
    weights = gg.edge_weight_planes(filters.gaussian_smooth(img, cfg.sigma),
                                    cfg.connectivity)[0]
    labels, flags = turbo.segment_turbo_impl(img.to(dev), cfg, 2,
                                             weights_override=weights)
    assert labels.device.type == "cuda"
    assert flags == cpu_flags == 0
    assert torch.equal(labels.cpu(), cpu_labels)


def _serpentine(h, w, lanes, thick=3, margin=4):
    """Label 1 on `lanes` horizontal lanes joined at alternating ends (a
    long thin component), label 0 elsewhere."""
    L = np.zeros((h, w), np.int32)
    ys = np.linspace(margin, h - margin - thick, lanes).astype(int)
    x0, x1 = margin, w - margin - thick
    for i, y in enumerate(ys):
        L[y:y + thick, x0:x1 + thick] = 1
        if i + 1 < lanes:
            x = x1 if i % 2 == 0 else x0
            L[y:ys[i + 1] + thick, x:x + thick] = 1
    return L


CLOSURE_SHAPES = SHAPES + [(40, 3840), (300, 301)]


@pytest.mark.parametrize("shape", CLOSURE_SHAPES)
@pytest.mark.parametrize("axis", [1, 0])
def test_closure_kernels_equal_plain(dev, shape, axis):
    h, w = shape
    f = _fields(h, w, dev, seed=h * 3 + w + axis, ncomp=3)
    cases = [(kg.compmin_closure, kg.compmin_closure_plain,
              (f["L"], f["bw"], f["be"], f["sz"])),
             (kg.labelnd_closure, kg.labelnd_closure_plain,
              (f["allow"], f["be"], f["bw"])),
             (kg.value_closure, kg.value_closure_plain, (f["L"], f["be"]))]
    for wrapper, plain, args in cases:
        n0 = list(wrapper.axis_launches)
        got, ref = wrapper(*args, axis), plain(*args, axis)
        assert _equal(got[:-1], ref[:-1]) and got[-1] is ref[-1]
        assert wrapper.axis_launches[axis] == n0[axis] + 1
        assert wrapper.axis_launches[1 - axis] == n0[1 - axis]


@pytest.mark.parametrize("h", [1, 2, 33, 1081, 2192])
def test_columns_closure_kernel_equals_plain(dev, h):
    """The columns launch against the plain closure, bit for bit, at heights
    below, at and across its row chunks and widths below, at and across its
    column blocks; column 0 takes its neighbour's value at every pixel,
    column 1 at none."""
    for w in (1, 7, 31, 33, 1919, 3840):
        f = _fields(h, w, dev, seed=h * 5 + w, ncomp=3)
        f["L"][:, 0] = 7
        f["allow"][:, 0] |= (1 << 5) | (1 << 1)
        if w > 1:
            f["L"][:, 1] = torch.arange(h, device=dev) % 2
            f["allow"][:, 1] &= ~((1 << 5) | (1 << 1))
        cases = [(kg.compmin_closure, kg.compmin_closure_plain,
                  (f["L"], f["bw"], f["be"], f["sz"])),
                 (kg.labelnd_closure, kg.labelnd_closure_plain,
                  (f["allow"], f["be"], f["bw"])),
                 (kg.value_closure, kg.value_closure_plain,
                  (f["L"], f["be"]))]
        for wrapper, plain, args in cases:
            got, ref = wrapper(*args, 0), plain(*args, 0)
            assert _equal(got[:-1], ref[:-1]) and got[-1] is ref[-1], (w,)


def test_closure_kernels_on_a_serpentine(dev):
    """Runs that span whole rows and columns: the closures carry a value
    across every chunk of the rows kernel and down every column."""
    h, w = 97, 1500
    L = torch.from_numpy(_serpentine(h, w, 5)).to(dev)
    rng = np.random.default_rng(3)
    val = torch.from_numpy(rng.integers(0, 1 << 30, (h, w)).astype(
        np.int32)).to(dev)
    for axis in (1, 0):
        got = kg.value_closure(L, val, axis)
        ref = kg.value_closure_plain(L, val, axis)
        assert _equal(got[:-1], ref[:-1]) and got[-1] is ref[-1] is True


@pytest.mark.parametrize("shape", [(23, 70), (96, 56), (37, 2600)])
def test_closure_route_fixpoints_equal_plain(dev, shape, monkeypatch):
    """closures=True from the first pass (WARM_PASSES = 0), the padded
    route included: the plain fixpoints' bits."""
    monkeypatch.setattr(kg, "WARM_PASSES", 0)
    h, w = shape
    f = _fields(h, w, dev, seed=h + w, ncomp=3)
    ms = 4 * (h + w)
    n0 = [c.launches for c in kg._CLOSURE_WRAPPERS.values()]
    got = kg.compmin_gossip(f["L"], f["bw"], f["be"], f["sz"], ms,
                            closures=True)
    ref = kg.compmin_gossip_plain(f["L"], f["bw"], f["be"], f["sz"], ms)
    assert _equal(got[:3], ref[:3]) and got[3] is ref[3] is False
    got = kg.label_flood(f["allow"], f["be"], f["bw"], ms, closures=True)
    ref = kg.label_flood_plain(f["allow"], f["be"], f["bw"], ms)
    assert _equal(got[:2], ref[:2]) and got[2] is ref[2] is False
    got = kg.value_flood(f["L"], f["be"], ms, closures=True)
    ref = kg.value_flood_plain(f["L"], f["be"], ms)
    assert torch.equal(got[0], ref[0]) and got[1] is ref[1] is False
    n1 = [c.launches for c in kg._CLOSURE_WRAPPERS.values()]
    assert all(b >= a + 2 for a, b in zip(n0, n1))


def test_closure_route_engages_past_the_warm_passes(dev):
    """A serpentine whose geodesic length (~3 x 1190 px, inside the plain
    sweep cap of 4 (h + w)) outruns WARM_PASSES x T = 512 px: at the
    default WARM_PASSES phase 2 runs, both orientations launch, and the
    result is the plain fixpoint."""
    h, w = 300, 1200
    L = torch.from_numpy(_serpentine(h, w, 3)).to(dev)
    rng = np.random.default_rng(5)
    val = torch.from_numpy(rng.integers(0, 1 << 30, (h, w)).astype(
        np.int32)).to(dev)
    ms = 4 * (h + w)
    kg.HYBRID_LOG.clear()
    n0 = list(kg.value_closure.axis_launches)
    got, unconv = kg.value_flood(L, val, ms, closures=True)
    ref, ref_unconv = kg.value_flood_plain(L, val, ms)
    assert torch.equal(got, ref) and unconv is ref_unconv is False
    assert [(v, s) for v, s, _ in kg.HYBRID_LOG] == [("value",
                                                      kg.WARM_PASSES)]
    assert kg.HYBRID_LOG[0][2] > 0
    assert all(b > a for a, b in zip(n0, kg.value_closure.axis_launches))


@pytest.mark.parametrize("shape", SHAPES + [(1080, 1920)])
def test_run_extract_kernel_equals_plain(dev, shape):
    h, w = shape
    rng = np.random.default_rng(h + w)
    L = torch.from_numpy(rng.integers(0, 3, (h, w)).astype(np.int32)).to(dev)
    vid = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w)
    n0 = kr.run_extract.launches
    for labels, cap in ((L, h * w), (vid, max(h * w // 2, 1))):
        got = kr.run_extract(labels, cap)
        ref = kr.run_extract_plain(labels, cap)
        assert int(got[2]) == int(ref[2]) and bool(got[3]) == bool(ref[3])
        if bool(got[3]):  # overflow: every slot filled, the rest dropped
            assert bool((got[0] != kr.INT32_MAX).all())
            continue
        n = int(got[2])

        def pairs(r):
            k = torch.stack([r[0][:n], r[1][:n]], 1).cpu().numpy()
            return k[np.lexsort(k.T[::-1])]
        assert np.array_equal(pairs(got), pairs(ref))
        assert bool((got[0][n:] == kr.INT32_MAX).all())
    assert kr.run_extract.launches == n0 + 2


def _run_pool(res):
    """(sorted pairs below the count, count, overflow) of a run pool; the
    slots past the count must hold the sentinels."""
    lab, cnt, count, ovf = (x.cpu() for x in res)
    n = min(int(count), lab.numel())
    if not bool(ovf):
        assert bool((lab[n:] == kr.INT32_MAX).all())
        assert bool((cnt[n:] == 0).all())
    k = torch.stack([lab[:n], cnt[:n]], 1).numpy()
    return k[np.lexsort(k.T[::-1])], int(count), bool(ovf)


@pytest.mark.parametrize("w", [1, 2, 31, 32, 33, 255, 256, 257, 1920, 2047,
                               2048, 2049, 3840])
@pytest.mark.parametrize("kind", ["one-run rows", "alternating",
                                  "identity"])
def test_run_extract_widths_and_caps(dev, w, kind):
    """Rows of one run, of runs of one pixel, and the identity labeling
    (every pixel a run of its own label), at widths across a warp, a block
    and a tile of csrc/runs.cu, at caps 0, 1, count - 1 and count: equal
    to the plain version as sorted multisets with the exact count; at
    overflow, every slot filled with pairs of the plane."""
    h = 7
    if kind == "one-run rows":
        L = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(
            h, w).contiguous()
    elif kind == "alternating":
        L = (torch.arange(h * w, device=dev).reshape(h, w) % 2).int()
    else:
        L = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w)
    count = int(kr.run_extract_plain(L, h * w)[2])
    full = _run_pool(kr.run_extract_plain(L, h * w))[0]
    for cap in sorted({0, 1, max(count - 1, 0), count}):
        n0 = kr.run_extract.launches
        got = _run_pool(kr.run_extract(L, cap))
        ref = _run_pool(kr.run_extract_plain(L, cap))
        assert kr.run_extract.launches == n0 + 1
        assert got[1:] == ref[1:] == (count, count > cap)
        if count <= cap:
            assert np.array_equal(got[0], ref[0])
        else:
            assert len(got[0]) == cap
            have = {tuple(p) for p in full.tolist()}
            assert all(tuple(p) in have for p in got[0].tolist())


def test_segment_atomic_on_card_equals_cpu(dev):
    """The atomic path on the card gives the CPU run's root ids at 96x128,
    and launches none of the kernels."""
    from gseg_tpu_torch.models import atomic_boruvka

    cfg = SegmentationConfig(k=200.0, min_size=20, algorithm="atomic")
    img = torch.from_numpy(blobs_image(96, 128, 6, 6.0, 11))
    n0 = (kg.compmin_gossip.launches, kx.boundary_extract.launches,
          kr.run_extract.launches)
    got = atomic_boruvka.segment_atomic(img.to(dev), cfg)
    assert got.device.type == "cuda"
    assert n0 == (kg.compmin_gossip.launches, kx.boundary_extract.launches,
                  kr.run_extract.launches)
    assert torch.equal(got.cpu(), atomic_boruvka.segment_atomic(img, cfg))
    levels, labels = gseg_tpu_torch.segment_hierarchy(img, config=cfg)
    cpu_levels, cpu_labels = atomic_boruvka.segment_atomic_hierarchy(img, cfg)
    assert torch.equal(levels.cpu(), cpu_levels)
    assert torch.equal(labels.cpu(), cpu_labels)


def test_turbo_hierarchy_on_card_equals_cpu(dev):
    """The turbo hierarchy on the card gives the CPU run's levels, labels
    and flags at the multi-tile 96x56 shape."""
    cfg = SegmentationConfig(k=200.0, min_size=20)
    img = torch.from_numpy(blobs_image(96, 56, 6, 6.0, 11))
    cpu = turbo.segment_turbo_hierarchy_flagged(img, cfg)
    got = turbo.segment_turbo_hierarchy_flagged(img.to(dev), cfg)
    assert got[0].device.type == "cuda"
    assert got[2] == cpu[2] == 0
    assert torch.equal(got[0].cpu(), cpu[0])
    assert torch.equal(got[1].cpu(), cpu[1])


@pytest.mark.parametrize("case", [
    dict(h=48, w=64, k=30.0, min_size=10, wb=16, seed=1, warm=None),
    dict(h=48, w=64, k=30.0, min_size=10, wb=8, seed=1, warm=0),
    dict(h=96, w=56, k=200.0, min_size=20, wb=16, seed=11, warm=0),
])
def test_quality_turbo_on_card_equals_cpu(dev, case, monkeypatch):
    """Quality mode on the card (closure route from the first pass where
    warm = 0) gives the CPU run's labels and flags, both fed the same
    weight planes."""
    if case["warm"] is not None:
        monkeypatch.setattr(kg, "WARM_PASSES", case["warm"])
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"],
                             weight_buckets=case["wb"])
    img = torch.from_numpy(blobs_image(case["h"], case["w"], 5, 4.0,
                                       case["seed"]))
    cpu_labels, cpu_flags = turbo.segment_turbo_impl(img, cfg, 2)
    weights = gg.edge_weight_planes(filters.gaussian_smooth(img, cfg.sigma),
                                    cfg.connectivity)[0]
    labels, flags = turbo.segment_turbo_impl(img.to(dev), cfg, 2,
                                             weights_override=weights)
    assert flags == cpu_flags == 0
    assert torch.equal(labels.cpu(), cpu_labels)


def test_runs_peel_on_card_equals_cpu(dev, monkeypatch):
    monkeypatch.setattr(turbo, "_PEEL_SIZES", "runs")
    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = torch.from_numpy(blobs_image(96, 56, 6, 6.0, 11))
    cpu_labels, cpu_flags = turbo.segment_turbo_impl(img, cfg, 2)
    weights = gg.edge_weight_planes(filters.gaussian_smooth(img, cfg.sigma),
                                    cfg.connectivity)[0]
    n0 = kr.run_extract.launches
    labels, flags = turbo.segment_turbo_impl(img.to(dev), cfg, 2,
                                             weights_override=weights)
    assert flags == cpu_flags == 0
    assert torch.equal(labels.cpu(), cpu_labels)
    assert kr.run_extract.launches > n0


def _step_inputs(variant, h, w, dev, seed):
    """(read-only plane, fields) of a step variant at random."""
    f = _fields(h, w, dev, seed=seed, ncomp=5)
    if variant == "compmin":
        return f["L"], [f["bw"], f["be"], f["sz"]]
    if variant == "labelnd":
        return f["allow"], [f["be"], f["bw"]]
    if variant == "value":
        return f["L"], [f["be"]]
    dist0, pdir = _dist_and_pdir(f["L"], seed=seed)
    if variant == "labeldist":
        return f["allow"], [f["be"], f["bw"], dist0]
    return pdir, [torch.ones_like(pdir)]


@pytest.mark.parametrize("shape", SHAPES + [(100, 130)])
@pytest.mark.parametrize("variant", list(kg._VARIANTS))
def test_gated_kernel_passes_equal_plain(dev, variant, shape):
    """Tile skipping on: every pass of a fixpoint, by the kernel and by
    step_pass_plain from the same input into copies of the same
    destination, gives the same fields, act bytes and changed flag."""
    h, w = shape
    ro, fields = _step_inputs(variant, h, w, dev, seed=h * 11 + w)
    tiles = (-(-h // kg._TILE), -(-w // kg._TILE))
    bufs = [[torch.zeros_like(x) for x in fields] for _ in range(2)]
    acts = [torch.zeros(tiles, dtype=torch.uint8, device=dev)
            for _ in range(2)]
    changed = torch.zeros(1, dtype=torch.int32, device=dev)

    def step(src, dst, act_in, act_out):
        pdst = [x.clone() for x in dst]
        _, ka, kc = kg.step_pass(variant, ro, src, dst, act_in)
        _, pa, pc = kg.step_pass_plain(variant, ro, src, pdst, act_in)
        assert _equal(dst, pdst) and torch.equal(ka, pa) and kc == pc
        act_out.copy_(ka)
        changed.bitwise_or_(int(kc))

    cap = -(-4 * (h + w) // kg.STEPS)
    n0 = kg._WRAPPERS[variant].launches
    out, unconv, n, _ = kg._pass_loop(step, None, fields, bufs, acts,
                                      changed, cap, cap, None, True)
    plain = {"compmin": kg.compmin_gossip_plain,
             "labeldist": kg.label_gossip_plain,
             "labelnd": kg.label_flood_plain,
             "value": kg.value_flood_plain,
             "subsum": kg.subtree_sums_plain}[variant]
    *ref, ref_unconv = plain(ro, *fields, 4 * (h + w))
    assert _equal(out, ref) and unconv is ref_unconv is False
    assert kg._WRAPPERS[variant].launches == n0 + n


@pytest.mark.parametrize("t", [4, 16, 32])
@pytest.mark.parametrize("variant", list(kg._VARIANTS))
def test_kernel_passes_at_each_t_equal_plain(dev, variant, t):
    """Each other instantiation of the step kernel (T = 8 above): every
    gated pass of a fixpoint, by the kernel and by step_pass_plain at the
    same T, gives the same fields, act bytes and changed flag; the passes
    reach the plain fixpoint."""
    h, w = 100, 130
    ro, fields = _step_inputs(variant, h, w, dev, seed=h * 11 + w + t)
    tiles = (-(-h // kg._TILE), -(-w // kg._TILE))
    bufs = [[torch.zeros_like(x) for x in fields] for _ in range(2)]
    acts = [torch.zeros(tiles, dtype=torch.uint8, device=dev)
            for _ in range(2)]
    changed = torch.zeros(1, dtype=torch.int32, device=dev)

    def step(src, dst, act_in, act_out):
        pdst = [x.clone() for x in dst]
        _, ka, kc = kg.step_pass(variant, ro, src, dst, act_in, t)
        _, pa, pc = kg.step_pass_plain(variant, ro, src, pdst, act_in, t)
        assert _equal(dst, pdst) and torch.equal(ka, pa) and kc == pc
        act_out.copy_(ka)
        changed.bitwise_or_(int(kc))

    cap = -(-4 * (h + w) // t)
    out, unconv, _, _ = kg._pass_loop(step, None, fields, bufs, acts,
                                      changed, cap, cap, None, True)
    plain = {"compmin": kg.compmin_gossip_plain,
             "labeldist": kg.label_gossip_plain,
             "labelnd": kg.label_flood_plain,
             "value": kg.value_flood_plain,
             "subsum": kg.subtree_sums_plain}[variant]
    *ref, ref_unconv = plain(ro, *fields, 4 * (h + w))
    assert _equal(out, ref) and unconv is ref_unconv is False


@pytest.mark.parametrize("t", [4, 16, 32])
@pytest.mark.parametrize("shape", [(96, 56), (37, 2600)])
def test_fixpoints_at_each_t_equal_plain(dev, t, shape, monkeypatch):
    """Every fixpoint wrapper with STEPS, STEPS_WIDE and STEPS_SCAN at t
    (two warm passes, then the closure pairs), the padded route included:
    the plain fixpoints' bits."""
    for name in ("STEPS", "STEPS_WIDE", "STEPS_SCAN"):
        monkeypatch.setattr(kg, name, t)
    monkeypatch.setattr(kg, "WARM_PASSES", 2)
    h, w = shape
    f = _fields(h, w, dev, seed=h + w + t, ncomp=3)
    ms = 4 * (h + w)
    got = kg.compmin_gossip(f["L"], f["bw"], f["be"], f["sz"], ms,
                            closures=True)
    ref = kg.compmin_gossip_plain(f["L"], f["bw"], f["be"], f["sz"], ms)
    assert _equal(got[:3], ref[:3]) and got[3] is ref[3] is False
    got = kg.label_flood(f["allow"], f["be"], f["bw"], ms, closures=True)
    ref = kg.label_flood_plain(f["allow"], f["be"], f["bw"], ms)
    assert _equal(got[:2], ref[:2]) and got[2] is ref[2] is False
    got = kg.value_flood(f["L"], f["be"], ms)
    ref = kg.value_flood_plain(f["L"], f["be"], ms)
    assert torch.equal(got[0], ref[0]) and got[1] is ref[1] is False
    dist0, pdir = _dist_and_pdir(f["L"], seed=t)
    got = kg.label_gossip(f["allow"], f["be"], f["bw"], dist0, ms)
    ref = kg.label_gossip_plain(f["allow"], f["be"], f["bw"], dist0, ms)
    assert _equal(got[:3], ref[:3]) and got[3] is ref[3] is False
    got = kg.subtree_sums(pdir, torch.ones_like(pdir), ms)
    ref = kg.subtree_sums_plain(pdir, torch.ones_like(pdir), ms)
    assert torch.equal(got[0], ref[0]) and got[1] is ref[1] is False


@pytest.mark.parametrize("tile_skip", [True, False])
def test_hybrid_route_equals_plain_with_and_without_skipping(
        dev, tile_skip, monkeypatch):
    """A few warm passes, then closure pairs: the pass after each closure
    runs every tile; results equal the plain fixpoints either way."""
    monkeypatch.setattr(kg, "TILE_SKIP", tile_skip)
    monkeypatch.setattr(kg, "WARM_PASSES", 1)
    h, w = 100, 1200
    L = torch.from_numpy(_serpentine(h, w, 3)).to(dev)
    rng = np.random.default_rng(4)
    val = torch.from_numpy(rng.integers(0, 1 << 30, (h, w)).astype(
        np.int32)).to(dev)
    ms = 4 * (h + w)
    got, unconv = kg.value_flood(L, val, ms, closures=True)
    ref, ref_unconv = kg.value_flood_plain(L, val, ms)
    assert torch.equal(got, ref) and unconv is ref_unconv is False
    f = _fields(h, w, dev, seed=8, ncomp=3)
    got = kg.label_flood(f["allow"], f["be"], f["bw"], ms, closures=True)
    ref = kg.label_flood_plain(f["allow"], f["be"], f["bw"], ms)
    assert _equal(got[:2], ref[:2]) and got[2] is ref[2] is False


def test_label_flood_seed_mask_changes_nothing(dev, monkeypatch):
    """Every label_flood call of the turbo path on the card, with and
    without its seed: the same outputs and the same number of passes."""
    monkeypatch.setattr(turbo, "_PEEL_SIZES", "count")
    orig = kg.label_flood
    seen = []

    def rec(bits, Lc, idf, max_sweeps, closures=False, seed_mask=None):
        n0 = orig.launches
        plain = orig(bits, Lc, idf, max_sweeps, closures)
        n1 = orig.launches
        got = orig(bits, Lc, idf, max_sweeps, closures, seed_mask)
        assert seed_mask is not None and _equal(got[:2], plain[:2])
        assert got[2] is plain[2] and orig.launches - n1 == n1 - n0
        seen.append(n1 - n0)
        return got

    monkeypatch.setattr(kg, "label_flood", rec)
    cfg = SegmentationConfig(k=300.0, min_size=100)
    for noise in (0.0, 6.0):
        img = torch.from_numpy(blobs_image(270, 480, 3, noise, 0)).to(dev)
        labels, flags = turbo.segment_turbo_impl(img, cfg, 2)
        assert flags == 0
    assert seen


def test_fastmst_on_card_equals_cpu(dev):
    """fastmst on the card gives the CPU run's root ids, flags and
    hierarchy at the multi-chunk 260x300 shape (several 131072-slot chunks,
    the V/16 run-out slice), through the value-flood kernel."""
    from gseg_tpu_torch.models import fastmst

    cfg = SegmentationConfig(k=150.0, min_size=20, algorithm="fastmst")
    img = torch.from_numpy(blobs_image(260, 300, 8, 8.0, 5))
    n0 = kg.value_flood.launches
    got, flags = fastmst.segment_fastmst_flagged(img.to(dev), cfg)
    assert kg.value_flood.launches > n0 and got.device.type == "cuda"
    want, wflags = fastmst.segment_fastmst_flagged(img, cfg)
    assert flags == wflags == 0 and torch.equal(got.cpu(), want)
    got = fastmst.segment_fastmst_hierarchy_flagged(img.to(dev), cfg)
    want = fastmst.segment_fastmst_hierarchy_flagged(img, cfg)
    assert got[2] == want[2] == 0
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_superpixel_on_card_equals_cpu_and_repeats(dev):
    """The superpixel hierarchy on the card gives the CPU run's levels at
    260x300, and two runs on the card are bit-equal (the colour sums go
    through the ordered scatter-add kernel, not atomics)."""
    from gseg_tpu_torch.models import superpixel
    from gseg_tpu_torch.ops.kernels import scatter as ks

    cfg = SegmentationConfig(k=150.0, min_size=1, max_iters=12,
                             algorithm="superpixel")
    img = torch.from_numpy(blobs_image(260, 300, 8, 8.0, 5))
    n0 = ks.ordered_scatter_add.launches
    a = superpixel.segment_superpixel_hierarchy_flagged(img.to(dev), cfg)
    assert ks.ordered_scatter_add.launches > n0
    b = superpixel.segment_superpixel_hierarchy_flagged(img.to(dev), cfg)
    want = superpixel.segment_superpixel_hierarchy_flagged(img, cfg)
    assert a[2] == b[2] == want[2] == 0
    assert torch.equal(a[0], b[0]) and torch.equal(a[0].cpu(), want[0])
    lvl, flags = superpixel.segment_superpixel_flagged(img.to(dev), cfg)
    assert flags == 0 and torch.equal(lvl.cpu(), want[0][4])


@pytest.mark.parametrize("n,v,c", [(1, 1, 3), (5000, 200, 3),
                                   (100_000, 3000, 1), (70_000, 50, 4),
                                   (2_000_000, 500_000, 3)])
def test_ordered_scatter_add_kernel_equals_plain(dev, n, v, c):
    """The kernel equals the plain version bit for bit: targets with long
    runs, dropped targets (negative and past the end), 1-4 floats a row."""
    from gseg_tpu_torch.ops.kernels import scatter as ks

    rng = np.random.default_rng(n + v + c)
    base = torch.from_numpy(rng.uniform(0, 255, (v, c)).astype(np.float32))
    idx = rng.integers(-3, v + 5, n).astype(np.int32)
    idx[: n // 3] = rng.integers(0, max(v // 50, 1), n // 3)
    idx = torch.from_numpy(idx)
    vals = torch.from_numpy(rng.uniform(0, 1e4, (n, c)).astype(np.float32))
    n0 = ks.ordered_scatter_add.launches
    got = ks.ordered_scatter_add(base.to(dev), idx.to(dev), vals.to(dev))
    assert ks.ordered_scatter_add.launches == n0 + 1
    plain = ks.ordered_scatter_add_plain(base.to(dev), idx.to(dev),
                                         vals.to(dev))
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), ks.ordered_scatter_add_plain(base, idx,
                                                               vals))


@pytest.mark.parametrize("shape,ns,ng", [((321, 481), 800, 90),
                                         ((37, 53), 5, 3)])
def test_asa_ue_torch_on_card_equals_numpy(dev, shape, ns, ng):
    """The dense overlap histogram on the card gives NumPy's floats
    exactly (integer sums divided once in float64, as NumPy divides), on
    30 random partitions each."""
    from gseg_tpu_torch.metrics.compare import asa_ue, asa_ue_torch

    for seed in range(30):
        rng = np.random.default_rng(seed * 1000 + ns + ng)
        seg = rng.integers(0, ns, shape).astype(np.int32)
        gt = rng.integers(0, ng, shape).astype(np.int32)
        asa, ue = asa_ue_torch(torch.from_numpy(seg).to(dev),
                               torch.from_numpy(gt).to(dev), ns, ng)
        assert asa.is_cuda and asa.dtype == torch.float64
        assert (float(asa), float(ue)) == asa_ue(seg, gt)


def test_colorize_on_card_equals_cpu(dev):
    """The colour table is drawn on the CPU and moved once: the card paints
    the CPU's colours."""
    from gseg_tpu_torch.utils.labels import colorize, colorize_hierarchy

    rng = np.random.default_rng(3)
    labels = torch.from_numpy(rng.integers(0, 60 * 70, (60, 70))
                              .astype(np.int32))
    got = colorize(labels.to(dev), seed=5)
    assert got.is_cuda and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), colorize(labels, seed=5))
    levels = torch.stack([labels, labels // 7 * 7])
    assert torch.equal(colorize_hierarchy(levels.to(dev), 5).cpu(),
                       colorize_hierarchy(levels, 5))


@pytest.mark.parametrize("shape", SHAPES + [(100, 130)])
@pytest.mark.parametrize("variant", list(kg._VARIANTS))
def test_slab_pass_kernel_equals_plain(dev, variant, shape):
    """The spatial fixpoints' ungated slab pass: the kernel and
    step_pass_plain from the same input give the same fields."""
    h, w = shape
    ro, fields = _step_inputs(variant, h, w, dev, seed=h * 13 + w)
    dk = [torch.empty_like(x) for x in fields]
    dp = [torch.empty_like(x) for x in fields]
    n0 = kg._WRAPPERS[variant].launches
    kg._slab_step_kernel(variant, ro, fields, dk)
    kg.step_pass_plain(variant, ro, fields, dp)
    assert _equal(dk, dp)
    assert kg._WRAPPERS[variant].launches == n0 + 1


@pytest.mark.parametrize("variant", list(kg._VARIANTS))
def test_spatial_fixpoint_on_card_equals_plain(dev, variant):
    """Four ranks on the card (6-row tiles, shorter than T): the slab
    route's fixpoint equals the dense plain fixpoint, with no sweep."""
    from gseg_tpu_torch.parallel.mesh import run_ranks

    spatial_fn = {"compmin": kg.compmin_gossip_spatial,
                  "labeldist": kg.label_gossip_spatial,
                  "labelnd": kg.label_flood_spatial,
                  "value": kg.value_flood_spatial,
                  "subsum": kg.subtree_sums_spatial}[variant]
    plain = {"compmin": kg.compmin_gossip_plain,
             "labeldist": kg.label_gossip_plain,
             "labelnd": kg.label_flood_plain, "value": kg.value_flood_plain,
             "subsum": kg.subtree_sums_plain}[variant]
    ro, fields = _step_inputs(variant, 24, 70, dev, seed=5)
    ms = 4 * (24 + 70)
    tiles = list(zip(ro.split(6), *[x.split(6) for x in fields]))
    out = run_ranks([dev] * 4, lambda r, t: spatial_fn(
        t[0].contiguous(), *[x.contiguous() for x in t[1:]], ms, r), tiles)
    *want, unconv = plain(ro, *fields, ms)
    got = [torch.cat([o[f] for o in out]) for f in range(len(fields))]
    assert _equal(got, want) and out[0][-1] is unconv is False


def test_parallel_paths_on_card_equal_dense(dev):
    """Batch, row-sharded turbo (8 ranks: 6-row tiles) and row-sharded
    atomic path on the card: equal to the dense paths there."""
    from gseg_tpu_torch.models import atomic_boruvka
    from gseg_tpu_torch.parallel import batching, spatial, turbo_spatial

    cfg = SegmentationConfig(k=120.0, min_size=8, algorithm="turbo")
    imgs = torch.stack([torch.from_numpy(blobs_image(48, 40, 5, 6.0, s))
                        for s in (2, 3)]).to(dev)
    labels = batching.segment_batch(imgs, cfg, dev)
    for i in range(2):
        dense, flags = turbo.segment_turbo_flagged(imgs[i], cfg, 2)
        assert flags == 0 and torch.equal(labels[i], dense)
    got, flags = turbo_spatial.segment_turbo_spatial(
        imgs[0], cfg, spatial.spatial_mesh([dev] * 8))
    assert flags == 0 and torch.equal(got, labels[0])
    acfg = SegmentationConfig(k=120.0, min_size=8, algorithm="atomic")
    m4 = spatial.spatial_mesh([dev] * 4)
    assert torch.equal(spatial.segment_spatial(imgs[1], acfg, m4),
                       atomic_boruvka.segment_atomic(imgs[1], acfg))


def _sleep_ms(dev):
    """A device sleep and its CUDA-event milliseconds."""
    cycles = 50_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles, start.elapsed_time(end)


def test_timers_wait_for_a_cuda_result(dev):
    """_timed and PhaseTimer stop their clocks only when the card is done:
    a call that queues a device sleep and returns at once measures at
    least the sleep's device time."""
    from gseg_tpu_torch.bench import harness
    from gseg_tpu_torch.utils import timing

    x = torch.zeros(4, device=dev)
    cycles, ms = _sleep_ms(dev)

    def queued():
        torch.cuda._sleep(cycles)
        return x + 1

    stats = harness._timed(queued, 3, inner=2)
    assert stats["min_s"] >= 0.9 * ms / 1e3
    timer = timing.PhaseTimer()
    with timer.phase("sleep") as out:
        out["result"] = queued()
    assert timer.phases["sleep"] >= 0.9 * ms / 1e3


def test_ladder_540p_turbo_row_on_card(dev):
    """One 540p turbo row of the ladder on the card: flags 0, and one more
    run 0 pixels off the rung's committed oracle."""
    from gseg_tpu_torch.bench import harness
    from gseg_tpu_torch.oracles import load_oracle, oracle_path
    from gseg_tpu_torch.utils.labels import canonical_min_labels_np

    row, = harness.run_performance_ladder(("turbo",), ((540, 960),), 2,
                                          device=dev)
    assert row["flags"] == 0 and row["total"]["median_s"] > 0
    labels = harness.segment_fn("turbo", SegmentationConfig(
        k=300.0, min_size=100))(harness.ladder_image(540, 960))
    assert labels.is_cuda
    got = canonical_min_labels_np(labels.cpu().numpy())
    assert np.array_equal(got, load_oracle(oracle_path("blobs_540x960_wb0")))


def test_parity_protocol_three_seeds_on_card(dev, capsys):
    """`python -m gseg_tpu_torch.bench.parity --seeds 3 --skip-540p` on
    cuda:0: every seed flags 0 and the host oracle's partition."""
    from gseg_tpu_torch.bench import parity

    parity.main(["--seeds", "3", "--skip-540p"])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"synthetic{s:03d}: flags=0 equal=True" for s in range(3)
                   ] + ["ALL PARITY CHECKS PASSED"]
    row = parity.check(parity.cases(1, skip_540p=True)[0], dev)
    assert row["equal"] and row["flags"] == 0 and row["components"] > 1


def test_spatial_parity_540p_row_on_card(dev):
    """One row of `bench.spatial_parity` on the card: 540p blobs on 4 ranks
    sharing cuda:0, speed mode; equal to the dense path, flags 0."""
    from gseg_tpu_torch.bench import spatial_parity

    row = spatial_parity.run_row("blobs", 540, 960, [dev] * 4, 0, dev)
    assert spatial_parity.row_ok(row), row


def test_sweep_rows_on_card(dev, tmp_path):
    """`python -m gseg_tpu_torch.bench.sweep` at 540p on cuda:0 (no
    --device): each row flags 0, the oracle's partition, the card's name
    and a median; the same labels under every config."""
    from gseg_tpu_torch.bench import sweep

    rows = sweep.main(["--shapes", "540x960", "--configs",
                       "baseline,nofastpad,finalgather", "--reps", "1",
                       "--out", str(tmp_path / "sweep.jsonl")])
    for row in rows:
        assert "error" not in row, row
        assert row["flags"] == 0 and row["oracle_equal"] is True
        assert row["card"].startswith(torch.cuda.get_device_name(0))
        assert row["median_ms"] > 0 and row["launches"]["gossip_compmin"]
    assert len({r["labels_sha256"] for r in rows}) == 1


def test_evidence_quality_rows_on_card(dev, tmp_path):
    """`bench.evidence --sections quality` on cuda:0, two images: every
    ASA and UE equal to bench_out/quality.jsonl."""
    import json
    import pathlib

    from gseg_tpu_torch.bench import evidence

    assert evidence.main(["--sections", "quality", "--quality-n", "2",
                          "--out", str(tmp_path)]) == 0
    root = pathlib.Path(__file__).resolve().parents[1]
    record = {(r["image"], r["algorithm"]): r for r in map(
        json.loads, (root / "bench_out/quality.jsonl").read_text()
        .splitlines())}
    rows = [json.loads(line) for line in
            (tmp_path / "quality.jsonl").read_text().splitlines()]
    assert len(rows) == 2 * len(evidence.QUALITY_ALGOS)
    for r in rows:
        ref = record[r["image"], r["algorithm"]]
        assert (r["asa"], r["ue"]) == (ref["asa"], ref["ue"]), r

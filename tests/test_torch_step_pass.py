"""The step kernel's tiled, gated pass (`step_pass_plain`) and its pass loop.

On the CPU, `step_pass_plain` stands in for csrc/gossip.cu's launch: one
T-step pass over 32x32 tiles with an 8-pixel halo that runs only the tiles
woken by the previous pass's act bytes. Iterated by the wrappers' own pass
loop (`_pass_loop`) it must reach the sweep-form plain fixpoints and the
reference's Pallas fixpoints (interpret mode) byte for byte, gated and
ungated alike, pass by pass, and in the pass count that the sweeps imply.
The loop's two-buffer rule and the seed_mask contract of `label_flood` are
held here too. The kernel itself is held against `step_pass_plain` on the
card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gseg_tpu.ops.pallas import gossip as pg  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops import grid_graph as gg  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

# multi-tile, ragged in both axes
SHAPES = [(70, 100), (37, 150)]
VARIANTS = list(kg._VARIANTS)
PLAIN = {"compmin": kg.compmin_gossip_plain,
         "labeldist": kg.label_gossip_plain,
         "labelnd": kg.label_flood_plain, "value": kg.value_flood_plain,
         "subsum": kg.subtree_sums_plain}
INT_SENTINEL, FLOAT_SENTINEL = -123456789, float("nan")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _inputs(variant, h, w, ncomp, seed):
    """(read-only plane, fields) of a variant from a random partition into
    `ncomp` labels; subsum gets a parent forest from BFS over same-label
    adjacency from sparse roots."""
    rng = np.random.default_rng(seed)
    L = _t(rng.integers(0, ncomp, (h, w)).astype(np.int32))
    same = kg.pack_allow_bits([gg.shift_plane(L, dy, dx, -1) == L
                               for dy, dx in gg.DIRS8])
    allow = same | _t(rng.integers(0, 256, (h, w)).astype(np.int32) & 0x11)
    bw = _t(rng.uniform(0, 1, (h, w)).astype(np.float32))
    be = _t(rng.integers(0, 10_000, (h, w)).astype(np.int32))
    sz = _t(rng.integers(1, 9, (h, w)).astype(np.int32))
    idf = _t(rng.uniform(0, 5, (h, w)).astype(np.float32))
    dist0 = _t(np.where(rng.random((h, w)) < 0.05, 0,
                        kg.BIGDIST).astype(np.int32))
    if variant == "compmin":
        return L, [bw, be, sz]
    if variant == "labeldist":
        return allow, [be, idf, dist0]
    if variant == "labelnd":
        return allow, [be, idf]
    if variant == "value":
        return L, [be]
    _, _, dist, unconv = kg.label_gossip_plain(same, L, torch.zeros((h, w)),
                                               dist0, 4 * (h + w))
    assert unconv is False
    return turbo._parent_dirs(L, dist), [torch.ones_like(L)]


def _reference(variant, ro, fields, ms):
    """The reference's Pallas fixpoint, step-only, in interpret mode."""
    j = [jnp.asarray(x.numpy()) for x in (ro, *fields)]
    with pltpu.force_tpu_interpret_mode():
        if variant == "compmin":
            out = pg.compmin_gossip(*j, ms, closures=False)[:3]
        elif variant == "labeldist":
            out = pg.label_gossip(*j, ms)[:3]
        elif variant == "labelnd":
            out = pg.label_flood(*j, ms, closures=False)[:2]
        elif variant == "value":
            out = pg.value_flood(*j, ms, closures=False)[:1]
        else:
            out = pg.subtree_sums(*j, ms)[:1]
    return [np.asarray(x) for x in out]


def _sentinel_like(x):
    return torch.full_like(x, FLOAT_SENTINEL if x.is_floating_point()
                           else INT_SENTINEL)


def _has_sentinel(x):
    return bool((torch.isnan(x) if x.is_floating_point()
                 else x == INT_SENTINEL).any())


def _drive(variant, ro, fields, ms, gate, seed_act=None, close=None,
           warm=None, on_pass=None):
    """_pass_loop with step_pass_plain as the launch, on scratch sets that
    start as sentinels. Returns (fields, unconverged, passes, pairs)."""
    h, w = ro.shape
    tiles = (-(-h // kg._TILE), -(-w // kg._TILE))
    bufs = [[_sentinel_like(x) for x in fields] for _ in range(2)]
    acts = [torch.zeros(tiles, dtype=torch.uint8) for _ in range(2)]
    changed = torch.zeros(1, dtype=torch.int32)

    def step(src, dst, act_in, act_out):
        _, a, ch = kg.step_pass_plain(variant, ro, src, dst, act_in)
        act_out.copy_(a)
        changed.bitwise_or_(int(ch))
        if on_pass is not None:
            on_pass(dst, a, ch)

    cap = -(-ms // kg.STEPS)
    return kg._pass_loop(step, close, fields, bufs, acts, changed, cap,
                         cap if warm is None else warm, seed_act, gate)


def _sweeps(variant, ro, fields, ms):
    """Sweeps of the plain fixpoint that change something."""
    k, cur = 0, list(fields)
    while True:
        *nxt, changed = PLAIN[variant](ro, *cur, 1)
        if not changed:
            return k
        k, cur = k + 1, nxt
        assert k <= ms


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_gated_passes_reach_the_plain_and_pallas_fixpoints(variant, shape):
    h, w = shape
    ro, fields = _inputs(variant, h, w, 7, seed=h * 31 + w)
    ms = 4 * (h + w)
    *plain, unconv = PLAIN[variant](ro, *fields, ms)
    assert unconv is False
    ref = _reference(variant, ro, fields, ms)
    sweeps = _sweeps(variant, ro, fields, ms)
    for gate in (True, False):
        out, unconv, passes, _ = _drive(variant, ro, fields, ms, gate)
        assert unconv is False
        # pass j covers sweeps (j - 1) T + 1 .. j T; one more certifies.
        assert passes == -(-sweeps // kg.STEPS) + 1
        for o, p, r in zip(out, plain, ref):
            assert torch.equal(o, p)
            assert np.array_equal(o.numpy(), r)


@pytest.mark.parametrize("ncomp", [1, 3, 50])
@pytest.mark.parametrize("variant", VARIANTS)
def test_gated_and_ungated_agree_after_every_pass(variant, ncomp):
    h, w = 70, 100
    ro, fields = _inputs(variant, h, w, ncomp, seed=ncomp)
    ms = 4 * (h + w)
    seen = {True: [], False: []}
    for gate in (True, False):
        _drive(variant, ro, fields, ms, gate,
               on_pass=lambda d, a, ch, g=gate: seen[g].append(
                   ([x.clone() for x in d], a.clone(), ch)))
    assert len(seen[True]) == len(seen[False]) > 0
    skipped = 0
    for (dg, ag, cg), (du, au, cu) in zip(seen[True], seen[False]):
        assert all(torch.equal(x, y) for x, y in zip(dg, du))
        assert torch.equal(ag, au) and cg == cu
        skipped += int((ag == 0).sum())
    if ncomp > 1:
        assert skipped > 0


def _ground_label_flood_inputs(img, cfg, peel, monkeypatch):
    """The (allow bits, Lc, idf, seed_mask) of every label_flood call that
    the port's _ground makes on `img` (CPU, plain versions)."""
    calls = []
    orig = kg.label_flood

    def rec(bits, Lc, idf, max_sweeps, closures=False, seed_mask=None):
        calls.append((bits, Lc, idf, seed_mask))
        return orig(bits, Lc, idf, max_sweeps, closures, seed_mask)

    monkeypatch.setattr(kg, "label_flood", rec)
    monkeypatch.setattr(turbo, "_PEEL_SIZES", peel)
    labels, flags = turbo.segment_turbo_impl(torch.from_numpy(img), cfg, 2)
    assert flags == 0
    assert all(c[3] is not None for c in calls)
    return calls


# tests/test_turbo.py's cases (noise 6), and blobs images of several tiles;
# on the noise-free one a later round's seed leaves tiles asleep.
GROUND_CASES = [
    dict(h=24, w=32, k=100.0, min_size=8, connectivity=8, seed=0, blobs=5),
    dict(h=33, w=17, k=300.0, min_size=20, connectivity=8, seed=1, blobs=5),
    dict(h=16, w=16, k=50.0, min_size=1, connectivity=4, seed=2, blobs=5),
    dict(h=1, w=37, k=100.0, min_size=5, connectivity=8, seed=3, blobs=5),
    dict(h=64, w=64, k=200.0, min_size=30, connectivity=8, seed=4, blobs=5),
    dict(h=135, w=240, k=300.0, min_size=100, connectivity=8, seed=0,
         blobs=8),
    dict(h=135, w=240, k=100.0, min_size=20, connectivity=8, seed=5,
         blobs=12),
    dict(h=135, w=240, k=300.0, min_size=100, connectivity=8, seed=0,
         blobs=3, noise=0.0),
]


@pytest.mark.parametrize("peel", ["count", "subsum"])
@pytest.mark.parametrize("case", GROUND_CASES)
def test_seed_mask_contract_on_ground_inputs(case, peel, monkeypatch):
    """Every label_flood input of _ground: the first T sweeps change
    nothing in a tile whose 3 x 3 tile neighbourhood holds no seed pixel,
    so the seeded first pass equals the ungated one, and the seeded
    fixpoint the plain one in the same number of passes."""
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"],
                             connectivity=case["connectivity"])
    img = blobs_image(case["h"], case["w"], case["blobs"],
                      case.get("noise", 6.0), case["seed"])
    calls = _ground_label_flood_inputs(img, cfg, peel, monkeypatch)
    # the count peel floods in every round; subsum from round 3 on.
    assert calls or peel == "subsum"
    unseeded = 0
    for bits, Lc, idf, seed in calls:
        h, w = Lc.shape
        tiles = (-(-h // kg._TILE), -(-w // kg._TILE))
        seed_act = kg._seed_act(seed, h, w, 0)
        woken = torch.nn.functional.max_pool2d(
            seed_act.reshape(1, 1, *tiles).float(), 3, 1, 1)[0, 0] > 0
        unseeded += int((~woken).sum())
        L8, id8, _ = kg.label_flood_plain(bits, Lc, idf, kg.STEPS)
        moved = torch.zeros((tiles[0] * kg._TILE, tiles[1] * kg._TILE),
                            dtype=torch.bool)
        moved[:h, :w] = (L8 != Lc) | (id8 != idf)
        moved = moved.view(tiles[0], kg._TILE, tiles[1], kg._TILE).any(
            3).any(1)
        assert not bool((moved & ~woken).any())
        ms = 4 * (h + w)
        ungated = _drive("labelnd", bits, [Lc, idf], ms, True)
        seeded = _drive("labelnd", bits, [Lc, idf], ms, True, seed_act)
        assert seeded[1:] == ungated[1:]
        assert all(torch.equal(x, y) for x, y in zip(seeded[0], ungated[0]))
    if case.get("noise") == 0.0 and peel == "count":
        assert unseeded > 0


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_no_sentinel_survives_in_any_pass(variant, seeded):
    """Both scratch sets start as sentinels; the loop copies the input
    into the ones a skipped tile may leave unwritten, so no pass's output
    holds a sentinel. The input is at its fixpoint but for a corner block,
    so pass 1 changes the corner tiles only and pass 2 skips the others;
    the seed wakes the corner tile alone in pass 1."""
    h, w = 100, 130
    # subsum: few labels, so the corner holds parents, not only leaves
    ro, fields = _inputs(variant, h, w, 3 if variant == "subsum" else 50,
                         seed=5)
    *start, unconv = PLAIN[variant](ro, *fields, 4 * (h + w))
    assert unconv is False
    for x, x0 in zip(start, fields):
        x[:8, :8] = x0[:8, :8]
    tiles = (-(-h // kg._TILE), -(-w // kg._TILE))
    seed_act = None
    if seeded:
        seed_act = torch.zeros(tiles, dtype=torch.uint8)
        seed_act[0, 0] = kg._ACT_SEED
    outs, acts = [], []

    def on_pass(d, a, ch):
        outs.append(any(_has_sentinel(x) for x in d))
        acts.append(a.clone())

    out, unconv, _, _ = _drive(variant, ro, start, 4 * (h + w), True,
                               seed_act, on_pass=on_pass)
    assert unconv is False and len(outs) >= 2 and not any(outs)
    assert int(acts[0].sum()) < acts[0].numel()
    *ref, _ = PLAIN[variant](ro, *start, 4 * (h + w))
    assert all(torch.equal(x, y) for x, y in zip(out, ref))


@pytest.mark.parametrize("warm", [0, 2])
@pytest.mark.parametrize("variant", ["compmin", "labelnd", "value"])
def test_hybrid_route_loop_gates_around_closures(variant, warm):
    """The closure route: each closure rewrites the planes in place, so the
    step pass after it runs every tile; the result is the plain fixpoint."""
    h, w = 37, 150
    ro, fields = _inputs(variant, h, w, 3, seed=warm + 9)
    ms = 4 * (h + w)
    closure = {"compmin": kg.compmin_closure_plain,
               "labelnd": kg.labelnd_closure_plain,
               "value": kg.value_closure_plain}[variant]
    tiles = (-(-h // kg._TILE), -(-w // kg._TILE))
    bufs = [[_sentinel_like(x) for x in fields] for _ in range(2)]
    acts = [torch.zeros(tiles, dtype=torch.uint8) for _ in range(2)]
    changed = torch.zeros(1, dtype=torch.int32)
    gated = []

    def step(src, dst, act_in, act_out):
        gated.append(act_in is not None)
        _, a, ch = kg.step_pass_plain(variant, ro, src, dst, act_in)
        act_out.copy_(a)
        changed.bitwise_or_(int(ch))

    def close(src, axis):
        *out, ch = closure(ro, *src, axis)
        for x, y in zip(src, out):
            x.copy_(y)
        changed.bitwise_or_(int(ch))

    cap = -(-ms // kg.STEPS)
    out, unconv, passes, pairs = kg._pass_loop(
        step, close, fields, bufs, acts, changed, cap, warm, None, True)
    *plain, p_unconv = PLAIN[variant](ro, *fields, ms)
    assert unconv is p_unconv is False and pairs > 0
    assert passes == warm + 2 * pairs == len(gated)
    assert all(torch.equal(x, y) for x, y in zip(out, plain))
    # pass 1 runs every tile, so does every pass after a closure; the
    # first pass of phase 2 follows a step pass.
    assert gated == [False] + [True] * (warm - 1) + [warm > 0] + [False] * (
        2 * pairs - 1) if warm else gated == [False] * passes


def test_step_pass_routes_cpu_tensors_to_the_plain_version():
    ro, fields = _inputs("compmin", 40, 70, 3, seed=1)
    dst = [torch.zeros_like(x) for x in fields]
    got = kg.step_pass("compmin", ro, fields, dst)
    ref = kg.step_pass_plain("compmin", ro, fields,
                             [torch.zeros_like(x) for x in fields])
    assert all(torch.equal(x, y) for x, y in zip(got[0], ref[0]))
    assert torch.equal(got[1], ref[1]) and got[2] == ref[2] is True
    assert got[0] is dst
    assert kg.compmin_gossip.launches == 0


def test_step_pass_and_seed_mask_checks_on_every_device():
    ro, fields = _inputs("labelnd", 40, 70, 3, seed=1)
    with pytest.raises(ValueError, match="act_in"):
        kg.step_pass("labelnd", ro, fields, fields,
                     torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="act_in"):
        kg.step_pass("labelnd", ro, fields, fields,
                     torch.zeros((3, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="seed_mask"):
        kg.label_flood(ro, *fields, 64, seed_mask=torch.zeros((40, 70)))
    with pytest.raises(ValueError, match="seed_mask"):
        kg.label_flood(ro, *fields, 64,
                       seed_mask=torch.zeros((40, 71), dtype=torch.bool))
    # the plain version ignores a valid seed
    seed = torch.zeros((40, 70), dtype=torch.bool)
    assert all(torch.equal(x, y) for x, y in zip(
        kg.label_flood(ro, *fields, 64, seed_mask=seed)[:2],
        kg.label_flood_plain(ro, *fields, 64)[:2]))


@pytest.mark.parametrize("row0", [0, 8])
def test_seed_act_marks_the_tiles_that_hold_seeds(row0):
    h, w = 70, 100
    seed = torch.zeros((h - row0, w), dtype=torch.bool)
    seed[0, 0] = seed[40 - row0, 99] = True
    act = kg._seed_act(seed, h, w, row0)
    want = torch.zeros((3, 4), dtype=torch.uint8)
    want[row0 // kg._TILE, 0] = want[40 // kg._TILE, 3] = kg._ACT_SEED
    assert act.dtype == torch.uint8 and torch.equal(act, want)

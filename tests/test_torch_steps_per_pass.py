"""Steps per pass (T) of the step kernel: 4, 8, 16 and 32.

csrc/gossip.cu instantiates its pass for each T of `kg.STEP_COUNTS`; the
fixpoints take `kg.STEPS` (`kg.STEPS_WIDE` on the padded route, at
w >= PAD_MIN_WIDTH) and the hybrid route's passes after the warm passes
`kg.STEPS_SCAN`. On the CPU, `step_pass_plain` at each T stands in for the
kernel: iterated by `_pass_loop`, and through `_run_fixpoint` itself (its
padding, seed rows and pass cap at the T of the call, with the kernels'
plain versions driving the passes), it must reach the plain fixpoint in
ceil(sweeps / T) + 1 passes, equal the T = 8 passes' result, and equal the
reference's Pallas flood (interpret mode) with GSEG_T set. The kernel at
each T is held against `step_pass_plain` on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
from gseg_tpu.ops import grid_graph as jgg  # noqa: E402
from gseg_tpu.ops.pallas import gossip as pg  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops import grid_graph as gg  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402
from gseg_tpu_torch.ops.kernels import pad as kp  # noqa: E402

OTHER_T = (4, 16, 32)
VARIANTS = list(kg._VARIANTS)
PLAIN = {"compmin": kg.compmin_gossip_plain,
         "labeldist": kg.label_gossip_plain,
         "labelnd": kg.label_flood_plain, "value": kg.value_flood_plain,
         "subsum": kg.subtree_sums_plain}
CLOSURE_PLAIN = {"compmin": kg.compmin_closure_plain,
                 "labelnd": kg.labelnd_closure_plain,
                 "value": kg.value_closure_plain}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _inputs(variant, h, w, ncomp, seed):
    """(read-only plane, fields) of a variant from a random partition into
    `ncomp` labels (subsum: a BFS parent forest from sparse roots)."""
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
    _, _, dist, _ = kg.label_gossip_plain(same, L, torch.zeros((h, w)),
                                          dist0, 4 * (h + w))
    return turbo._parent_dirs(L, dist), [torch.ones_like(L)]


def _loop(variant, ro, fields, ms, t, gate=True):
    """_pass_loop with step_pass_plain at t steps a pass. Returns (fields,
    unconverged, passes)."""
    h, w = ro.shape
    tiles = (-(-h // kg._TILE), -(-w // kg._TILE))
    bufs = [[torch.zeros_like(x) for x in fields] for _ in range(2)]
    acts = [torch.zeros(tiles, dtype=torch.uint8) for _ in range(2)]
    changed = torch.zeros(1, dtype=torch.int32)

    def step(src, dst, act_in, act_out):
        _, a, ch = kg.step_pass_plain(variant, ro, src, dst, act_in, t)
        act_out.copy_(a)
        changed.bitwise_or_(int(ch))

    cap = -(-ms // t)
    out, unconv, n, _ = kg._pass_loop(step, None, fields, bufs, acts,
                                      changed, cap, cap, None, gate)
    return out, unconv, n


def _sweeps(variant, ro, fields, ms):
    """Sweeps of the plain fixpoint that change something."""
    k, cur = 0, list(fields)
    while True:
        *nxt, changed = PLAIN[variant](ro, *cur, 1)
        if not changed:
            return k
        k, cur = k + 1, nxt
        assert k <= ms


def _plain_passes(log):
    """A `passes` for kg._run_fixpoint that drives `_pass_loop` as
    `_passes` does, with the kernels' plain versions: step_pass_plain at t
    (STEPS_SCAN in the closure pairs) and the closures' plain launches.
    Appends (t, step passes, pairs) of each call to log."""
    def passes(variant, ro, fields, max_passes, closures, seed_act, t):
        h, w = ro.shape
        tiles = (-(-h // kg._TILE), -(-w // kg._TILE))
        bufs = [[torch.empty_like(x) for x in fields] for _ in range(2)]
        acts = [torch.empty(tiles, dtype=torch.uint8) for _ in range(2)]
        changed = torch.zeros(1, dtype=torch.int32)

        def step_at(tt):
            def step(src, dst, act_in, act_out):
                _, a, ch = kg.step_pass_plain(variant, ro, src, dst, act_in,
                                              tt)
                act_out.copy_(a)
                changed.bitwise_or_(int(ch))
            return step

        def close(src, axis):
            *out, ch = CLOSURE_PLAIN[variant](ro, *src, axis)
            for x, o in zip(src, out):
                x.copy_(o)
            changed.bitwise_or_(int(ch))

        warm = min(max_passes, kg.WARM_PASSES) if closures else max_passes
        out, unconv, n, pairs = kg._pass_loop(
            step_at(t), close if closures else None, fields, bufs, acts,
            changed, max_passes, warm, seed_act, kg.TILE_SKIP,
            step_at(kg.STEPS_SCAN))
        log.append((t, n, pairs))
        return out, unconv
    return passes


@pytest.mark.parametrize("t", OTHER_T)
@pytest.mark.parametrize("variant", VARIANTS)
def test_passes_at_t_reach_the_fixpoint(variant, t):
    """Gated passes of t steps reach the plain fixpoint, and the T = 8
    passes' result, in ceil(sweeps / t) + 1 passes."""
    h, w = 70, 100
    ro, fields = _inputs(variant, h, w, 7, seed=h * 31 + w)
    ms = 4 * (h + w)
    *plain, unconv = PLAIN[variant](ro, *fields, ms)
    assert unconv is False
    at8 = _loop(variant, ro, fields, ms, 8)[0]
    out, unconv, n = _loop(variant, ro, fields, ms, t)
    assert unconv is False
    assert n == -(-_sweeps(variant, ro, fields, ms) // t) + 1
    for o, p, e in zip(out, plain, at8):
        assert torch.equal(o, p) and torch.equal(o, e)


@pytest.mark.parametrize("t", OTHER_T)
def test_gated_pass_equals_ungated_at_t(t):
    """At each t, a gated pass equals the ungated pass from the same input
    (the skip's soundness: a slab of t <= TILE lies in the 3 x 3 tiles)."""
    ro, fields = _inputs("labelnd", 70, 100, 3, seed=t)
    src, act = fields, None
    for _ in range(4):
        gated = [torch.zeros_like(x) for x in src]
        full = [torch.zeros_like(x) for x in src]
        for x, y in zip(gated, src):
            x.copy_(y)
        _, a_g, ch_g = kg.step_pass_plain("labelnd", ro, src, gated, act, t)
        _, a_f, ch_f = kg.step_pass_plain("labelnd", ro, src, full, None, t)
        assert all(torch.equal(x, y) for x, y in zip(gated, full))
        assert torch.equal(a_g, a_f) and ch_g == ch_f
        src, act = gated, a_g


@pytest.mark.parametrize("t", [16, 32])
def test_label_flood_at_t_matches_pallas(monkeypatch, t):
    """The reference's multi-strip flood test case with GSEG_T set: its
    Pallas flood (interpret mode) equals the port's fixpoint route at
    kg.STEPS = t, driven by the plain passes, and the XLA sweeps."""
    monkeypatch.setenv("GSEG_T", str(t))
    h, w = 160, 140
    rng = np.random.default_rng(7)
    comp = (np.arange(w)[None, :] // 3) * 2 + (np.arange(h)[:, None] >= 100)
    L = np.broadcast_to(comp, (h, w)).astype(np.int32)
    idf = rng.uniform(0, 5, (h, w)).astype(np.float32)
    Lc0 = ((h - np.arange(h))[:, None] * 1000
           + np.arange(w)[None, :]).astype(np.int32)
    ms = 4 * (h + w)
    jL = jnp.asarray(L)
    nbrL = jnp.stack([jgg.shift_plane(jL, dy, dx, -1) for dy, dx in jgg.DIRS8])
    allow_l = [nbrL[d] == jL for d in range(8)]
    rL, rI, _ = ref_turbo._label_gossip_nd(jnp.asarray(Lc0), allow_l,
                                           jnp.asarray(idf), ms)
    with pltpu.force_tpu_interpret_mode():
        gL, gI, g_unconv, _ = pg.label_flood(
            pg.pack_allow_bits(allow_l), jnp.asarray(Lc0), jnp.asarray(idf),
            ms, closures=False)
    monkeypatch.setattr(kg, "STEPS", t)
    bits = torch.from_numpy(np.array(pg.pack_allow_bits(allow_l)))
    log = []
    (Lc, idn), unconv = kg._run_fixpoint(
        "labelnd", bits, [torch.from_numpy(Lc0), torch.from_numpy(idf)], ms,
        False, passes=_plain_passes(log))
    assert log[0][0] == t and unconv is bool(g_unconv) is False
    assert np.array_equal(Lc.numpy(), np.asarray(gL))
    assert np.array_equal(idn.numpy(), np.asarray(gI))
    assert np.array_equal(Lc.numpy(), np.asarray(rL))


@pytest.mark.parametrize("variant,t", [
    (v, t) for t in (4, 16) for v in CLOSURE_PLAIN] + [("value", 32)])
def test_padded_hybrid_route_at_t(monkeypatch, variant, t):
    """A wide plane (the padded route) at STEPS_WIDE = t, its closure pairs
    at STEPS_SCAN = 4 after two warm passes, the label flood with a seed
    mask (seeded on the padded plane's rows from t): the plain fixpoint,
    with the pads at t."""
    h, w = 20, 2563
    ro, fields = _inputs(variant, h, w, 40, seed=t)
    ms = 4 * (h + w)
    *plain, _ = PLAIN[variant](ro, *fields, ms)
    monkeypatch.setattr(kg, "STEPS_WIDE", t)
    monkeypatch.setattr(kg, "STEPS_SCAN", 4)
    monkeypatch.setattr(kg, "WARM_PASSES", 2)
    pads = []
    fn = kp.fast_pad_fields

    def pad(planes, tt, hp, wp):
        pads.append(tt)
        return fn(planes, tt, hp, wp)
    monkeypatch.setattr(kp, "fast_pad_fields", pad)
    seed = torch.ones((h, w), dtype=torch.bool) if variant == "labelnd" \
        else None
    log = []
    out, unconv = kg._run_fixpoint(variant, ro, fields, ms, True, seed,
                                   passes=_plain_passes(log))
    assert pads == [t] and log[0][0] == t and unconv is False
    assert all(torch.equal(o, p) for o, p in zip(out, plain))


def test_steps_outside_the_instantiated_refused():
    """A T the kernel is not instantiated for is refused on every device,
    before any launch."""
    ro, fields = _inputs("value", 40, 40, 3, seed=1)
    dst = [torch.zeros_like(x) for x in fields]
    for t in (0, 12, 33, 64):
        with pytest.raises(ValueError, match="steps per pass"):
            kg.step_pass_plain("value", ro, fields, dst, None, t)
        with pytest.raises(ValueError, match="steps per pass"):
            kg.step_pass("value", ro, fields, dst, None, t)
    assert kg.STEP_COUNTS == (4, 8, 16, 32)
    assert kg.STEPS == kg.STEPS_WIDE == kg.STEPS_SCAN == 8

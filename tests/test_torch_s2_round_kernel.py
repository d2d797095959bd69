"""The hand-written stage-2 round (`ops.kernels.s2round`) on the CPU.

Its plain version (the kernel's steps over the state's label slots, with
`scatter_reduce` in place of the atomics) must be byte-equal to
`turbo._s2_round_ops`, the round as PyTorch ops, in every output: esrc,
edst, SZf, IDf, fin, merged and the flags. Driven on made-up pools (ties
of (w, eeid) within a source, a hook target with no live edge, more heads
than the cap, a hook chain through every slot) and on the handoff states
of small speed and quality frames, root-indexed and V-indexed; felz
rounds with and without a weight cap and min-size rounds; canonical and
sink labels. Then whole `_s2_stage` runs, whose rounds on the CPU take
the plain version, against the same stages on the ops. On a card `tests/test_torch_cuda.py` holds the kernel to the
same ops."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops.kernels import s2round  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

KINDS = ("felz", "felz_capped", "min_size")
OUTS = ("esrc", "edst", "SZf", "IDf", "fin", "merged", "flags")


def _state(esrc, edst, ew, eeid, SZf, IDf, fin, flags=0):
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    return turbo.CompactState(
        esrc=t(esrc, torch.int32), edst=t(edst, torch.int32),
        ew=t(ew, torch.float32), eeid=t(eeid, torch.int32),
        SZf=t(SZf, torch.int32), IDf=t(IDf, torch.float32),
        fin=t(fin, torch.int32), merged=True, it=0, bucket=0, phase=0,
        flags=torch.tensor(flags, dtype=torch.int32))


def _pool(rng, n, m, c):
    """m undirected edges on n labels, each in both orientations, shuffled:
    weights on a coarse grid (ties across edges), a tenth dead (+inf),
    distinct edge ids; sizes, Int and a root map at random."""
    a, b = rng.integers(0, n, m), rng.integers(0, n, m)
    w = (rng.integers(0, 8, m) * 0.5).astype(np.float32)
    w[rng.random(m) < 0.1] = np.inf
    eid = rng.permutation(10 * m)[:m]
    perm = rng.permutation(2 * m)
    return (np.concatenate([a, b])[perm], np.concatenate([b, a])[perm],
            np.concatenate([w, w])[perm], np.concatenate([eid, eid])[perm],
            rng.integers(1, 30, n), rng.integers(0, 6, n) * 0.25,
            rng.integers(0, n, c))


def _random(rng):
    return _state(*_pool(rng, 40, 60, 24)), 64


def _ties(rng):
    """Each source's least (w, eeid) held by several entries, at scattered
    positions, to other targets: the lowest position's target wins."""
    esrc, edst, ew, eeid, SZf, IDf, fin = _pool(rng, 30, 40, 16)
    dup = rng.integers(0, len(esrc), 24)
    esrc = np.concatenate([esrc, esrc[dup]])
    edst = np.concatenate([edst, rng.integers(0, 30, 24)])
    ew = np.concatenate([ew, ew[dup]])
    eeid = np.concatenate([eeid, eeid[dup]])
    perm = rng.permutation(len(esrc))
    return _state(esrc[perm], edst[perm], ew[perm], eeid[perm], SZf, IDf,
                  fin), 64


def _non_head_target(rng):
    """Labels 6-9 have no live edge of their own (their entries are dead
    or only point at them), so hooks to them end the chain there."""
    esrc, edst, ew, eeid, SZf, IDf, fin = _pool(rng, 12, 14, 8)
    keep = ~np.isin(esrc, [6, 7, 8, 9]) | ~np.isfinite(ew)
    esrc, edst, ew, eeid = esrc[keep], edst[keep], ew[keep], eeid[keep]
    one_way = np.array([0, 1, 2, 3])
    return _state(np.concatenate([esrc, one_way]),
                  np.concatenate([edst, one_way + 6]),
                  np.concatenate([ew, np.zeros(4)]),
                  np.concatenate([eeid, 1000 + one_way]), SZf, IDf,
                  fin), 16


def _overflow(rng):
    """More heads than the cap: heads past it drop out, and hooks to them
    end the chain."""
    return _state(*_pool(rng, 40, 60, 24), flags=2), 9


def _long_chain(rng):
    """A path 0 - 1 - ... - 199 whose weights fall along it: every label
    hooks to the next, one chain through all 200 slots."""
    n = 200
    a = np.arange(n - 1)
    w = np.linspace(100.0, 1.0, n - 1).astype(np.float32)
    return _state(np.concatenate([a, a + 1]), np.concatenate([a + 1, a]),
                  np.concatenate([w, w]), np.concatenate([a, a]),
                  np.ones(n), np.zeros(n), np.arange(0, n, 3)), 256


MADE = {"random": _random, "ties": _ties,
        "non_head_target": _non_head_target, "overflow": _overflow,
        "long_chain": _long_chain}


def _round_args(st, kind, thresholds=None):
    """(is_felz, tau, k, min_size) of a round of this kind."""
    tau = None
    if kind == "felz_capped":
        tau = (thresholds[len(thresholds) // 3] if thresholds is not None
               else torch.quantile(st.ew[torch.isfinite(st.ew)], 0.5))
        tau = tau.to(torch.float32)
    return kind != "min_size", tau, 1e4 if kind == "felz" else 3.0, 12


def _assert_equal(st, n, head_cap, kind, canonical, thresholds=None):
    is_felz, tau, k, min_size = _round_args(st, kind, thresholds)
    want = turbo._s2_round_ops(st, n, head_cap, k, min_size, is_felz, tau,
                               canonical)
    got = s2round.s2_round(
        st.esrc, st.edst, st.ew, st.eeid, st.SZf, st.IDf, st.fin, st.flags,
        head_cap=head_cap, k=k, min_size=min_size, is_felz=is_felz, tau=tau,
        canonical=canonical)
    for name, a, b in zip(OUTS, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    return want


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(MADE))
def test_plain_round_equals_ops_on_made_pools(case, kind, canonical):
    for seed in range(6):
        st, head_cap = MADE[case](np.random.default_rng(seed))
        n = st.SZf.numel()
        want = _assert_equal(st, n, head_cap, kind, canonical)
        heads = int(torch.unique(st.esrc[(st.esrc != st.edst)
                                         & torch.isfinite(st.ew)]).numel())
        if case == "overflow" and kind != "felz_capped":
            assert heads > head_cap
            assert int(want[6]) == turbo.FLAG_COMP_OVERFLOW | 2
        if case == "long_chain" and kind == "felz":
            # one cluster: every label's final root is the chain's
            assert torch.unique(want[4]).numel() == 1


# (h, w, blobs, seed, k, weight_buckets): 96x80 frames' handoffs
FRAMES = {"speed": (96, 80, 12, 5, 120.0, 0),
          "quality": (96, 80, 6, 5, 300.0, 16)}


@pytest.fixture
def small_caps(monkeypatch):
    # capacities proportional to V at these sizes
    monkeypatch.setattr(turbo, "_CAP_FLOOR", 64)
    monkeypatch.setattr(turbo, "_RLIST_FLOOR", 64)


def _handoff(frame, min_size=20):
    h, w, blobs, seed, k, wb = FRAMES[frame]
    img = torch.from_numpy(blobs_image(h, w, blobs, 6.0, seed))
    cfg = SegmentationConfig(k=k, min_size=min_size, algorithm="turbo",
                             weight_buckets=wb)
    gst, weights, thr = turbo._stage_g(img, cfg, 2)
    st, rm, r0 = turbo._extract_stage(gst, weights, cfg)
    return cfg, thr, st, r0


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("space", ["root", "v_indexed"])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_plain_round_equals_ops_on_handoff_states(small_caps, frame, space,
                                                  kind, canonical):
    cfg, thr, st, r0 = _handoff(frame)
    v = FRAMES[frame][0] * FRAMES[frame][1]
    head_cap = turbo.capacities(v, cfg.weight_buckets)["comp_cap"]
    if space == "root":
        st = turbo._to_root_space(st, r0)
    n = st.SZf.numel()
    assert n == (r0.numel() if space == "root" else v)
    # three rounds in a row, each from the last one's state
    for _ in range(3):
        esrc, edst, SZf, IDf, fin, merged, flags = _assert_equal(
            st, n, head_cap, kind, canonical, thr)
        st = st._replace(esrc=esrc, edst=edst, SZf=SZf, IDf=IDf, fin=fin,
                         flags=flags)


def _ops_rounds(monkeypatch):
    """Every round of `_s2_round` on `_s2_round_ops` in place of the
    hand-written round's plain version."""
    def ops(esrc, edst, ew, eeid, SZf, IDf, fin, flags, *, head_cap, k,
            min_size, is_felz, tau=None, canonical=True):
        st = turbo.CompactState(
            esrc=esrc, edst=edst, ew=ew, eeid=eeid, SZf=SZf, IDf=IDf,
            fin=fin, merged=True, it=0, bucket=0, phase=0, flags=flags)
        return turbo._s2_round_ops(st, SZf.numel(), head_cap, k, min_size,
                                   is_felz, tau, canonical)

    monkeypatch.setattr(s2round, "s2_round", ops)


@pytest.mark.parametrize("root_space", [True, False])
@pytest.mark.parametrize("min_size", [1, 20])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_stage_on_plain_rounds_equals_ops(small_caps, monkeypatch, frame,
                                          min_size, root_space):
    cfg, thr, st, r0 = _handoff(frame, min_size)
    v = FRAMES[frame][0] * FRAMES[frame][1]
    r0 = r0 if root_space else None
    got = turbo._s2_stage(st, v, cfg, thr, r0)
    _ops_rounds(monkeypatch)
    want = turbo._s2_stage(st, v, cfg, thr, r0)
    for name in ("esrc", "edst", "ew", "eeid", "SZf", "IDf", "fin"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(got.flags) == int(want.flags) and got.it == want.it


def test_scratch_and_jump_launches():
    """The scratch holds the kernel's slot arrays; the jump launches reach
    at least the ops' pointer-doubling steps."""
    assert s2round.scratch_bytes(1) == 32 + 8
    assert s2round.scratch_bytes(86400) == 32 * 86400 + 8 * 85
    for cap, n in ((1, 1), (8, 100), (86400, 86400), (1 << 20, 1 << 22),
                   (4147200, 8294400)):
        steps = max(min(cap, n).bit_length() + 1, 4)
        launches = s2round.jump_launches(cap, n)
        assert 5 * launches >= steps > 5 * (launches - 1)


def test_wrapper_checks_its_arguments():
    st, _ = _random(np.random.default_rng(0))
    args = (st.esrc, st.edst, st.ew, st.eeid, st.SZf, st.IDf, st.fin)
    with pytest.raises(ValueError):
        s2round.s2_round(*args, st.flags.to(torch.int64), head_cap=8, k=1.0,
                         min_size=1, is_felz=True)
    with pytest.raises(ValueError):
        s2round.s2_round(st.esrc, st.edst[:-1], *args[2:], st.flags,
                         head_cap=8, k=1.0, min_size=1, is_felz=True)

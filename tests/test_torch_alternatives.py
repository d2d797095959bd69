"""The turbo path's exact alternative routes against the reference's.

Each module attribute of `gseg_tpu_torch.models.turbo` selects the route
that one of `gseg_tpu`'s GSEG_* environment variables selects there: the
final-map gather (`_FINAL_GATHER`, GSEG_FINAL_GATHER=1) on the dense path,
the hierarchy and the row-sharded path; the pointer-resolved flood of the
root-list rounds (`_FLOOD_PTR`, GSEG_FLOOD_PTR=1); the root-list loop
unsplit or over tiers (`_RLIST_SPLIT`, `_RLIST_TIERS_Q`); the closure
routing (`_LATE_CLOSURES`, `_Q_CLOSURES`); and the capacities `_RUNS_DIV`
and `_S2_SMALL_DIV(_Q)`. Under each, the port's labels and flags must be
byte-equal to the reference's run with the variable set (the reference
reads them at trace time, so its jit caches are cleared around each run),
at the sizes of the reference's own tests of these switches. The default
algorithm of the public entry points is the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gseg_tpu  # noqa: E402
from gseg_tpu import cli as ref_cli  # noqa: E402
from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
from gseg_tpu.models.boruvka_cpu import segment_boruvka_np  # noqa: E402
from gseg_tpu.parallel import spatial as ref_spatial  # noqa: E402
from gseg_tpu.parallel import turbo_spatial as ref_ts  # noqa: E402
import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch import cli  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402
from gseg_tpu_torch.ops.kernels import runs as kr  # noqa: E402
from gseg_tpu_torch.parallel.spatial import spatial_mesh  # noqa: E402
from gseg_tpu_torch.parallel.turbo_spatial import (  # noqa: E402
    segment_turbo_spatial)
from gseg_tpu_torch.utils.labels import canonical_min_labels_np  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

# the reference's test cases of these switches (tests/test_turbo.py):
# GSEG_FLOOD_PTR at 40x56 seed 13, the root-list split at 48x56 seed 9
SPEED = SegmentationConfig(k=120.0, min_size=10, algorithm="turbo")
QUALITY = SegmentationConfig(k=30.0, min_size=10, weight_buckets=8,
                             algorithm="turbo")
MODES = {"speed": SPEED, "quality": QUALITY}
IMG_PTR = blobs_image(40, 56, 6, 6.0, 13)
IMG_SPLIT = blobs_image(48, 56, 6, 6.0, 9)


def _ref_cfg(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


def _with_env(monkeypatch, env, fn):
    """fn() with the reference's variables set, its jit caches cleared
    before and after (the variables are read at trace time)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jax.clear_caches()
    try:
        return fn()
    finally:
        for k in env:
            monkeypatch.delenv(k, raising=False)
        jax.clear_caches()


def _ref(img, cfg, env, monkeypatch):
    labels, flags = _with_env(
        monkeypatch, env, lambda: ref_turbo.segment_turbo_flagged(
            jnp.asarray(img), _ref_cfg(cfg), 2))
    return np.asarray(labels), int(flags)


def _port(img, cfg):
    labels, flags = turbo.segment_turbo_flagged(torch.from_numpy(img), cfg,
                                                2)
    return labels.numpy(), flags


def _oracle(img, cfg):
    return canonical_min_labels_np(segment_boruvka_np(img, _ref_cfg(cfg)))


def _count_calls(monkeypatch, mod, name, calls):
    """Wrap mod.name, appending each call's keyword arguments to calls."""
    fn = getattr(mod, name)

    def rec(*a, **kw):
        calls.append(kw)
        return fn(*a, **kw)
    monkeypatch.setattr(mod, name, rec)


@pytest.mark.parametrize("mode", list(MODES))
def test_final_gather_matches_reference(monkeypatch, mode):
    """GSEG_FINAL_GATHER=1: the final map as one gather of the root table;
    no value flood runs."""
    cfg = MODES[mode]
    want = _ref(IMG_PTR, cfg, {"GSEG_FINAL_GATHER": "1"}, monkeypatch)
    monkeypatch.setattr(turbo, "_FINAL_GATHER", True)
    floods = []
    _count_calls(monkeypatch, kg, "value_flood", floods)
    labels, flags = _port(IMG_PTR, cfg)
    assert floods == []
    assert flags == want[1] == 0
    assert np.array_equal(labels, want[0])
    assert np.array_equal(labels, _oracle(IMG_PTR, cfg))


def test_final_gather_hierarchy_matches_reference(monkeypatch):
    """GSEG_FINAL_GATHER=1 on the turbo hierarchy: every stage-2 level and
    the final map by the gather, no value flood; levels, labels and flags
    byte-equal."""
    want = _with_env(
        monkeypatch, {"GSEG_FINAL_GATHER": "1"},
        lambda: ref_turbo.segment_turbo_hierarchy_flagged(
            jnp.asarray(IMG_PTR), _ref_cfg(SPEED)))
    monkeypatch.setattr(turbo, "_FINAL_GATHER", True)
    floods = []
    _count_calls(monkeypatch, kg, "value_flood", floods)
    levels, labels, flags = turbo.segment_turbo_hierarchy_flagged(
        torch.from_numpy(IMG_PTR), SPEED)
    assert floods == []
    assert flags == int(want[2]) == 0
    assert np.array_equal(levels.numpy(), np.asarray(want[0]))
    assert np.array_equal(labels.numpy(), np.asarray(want[1]))


@pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 virtual devices")
def test_final_gather_spatial_matches_reference(monkeypatch):
    """GSEG_FINAL_GATHER=1 on the row-sharded path over 4 ranks: a local
    gather of the replicated root table, labels equal to the reference's
    on a 4-device CPU mesh and to the dense path's."""
    img = blobs_image(48, 40, 5, 6.0, 2)
    cfg = dataclasses.replace(SPEED, k=120.0, min_size=8)
    want, want_flags = _with_env(
        monkeypatch, {"GSEG_FINAL_GATHER": "1"},
        lambda: ref_ts.segment_turbo_spatial(
            jnp.asarray(img), _ref_cfg(cfg),
            ref_spatial.spatial_mesh(jax.devices()[:4]), gossip_rounds=4))
    monkeypatch.setattr(turbo, "_FINAL_GATHER", True)
    floods = []
    _count_calls(monkeypatch, kg, "value_flood_spatial", floods)
    labels, flags = segment_turbo_spatial(img, cfg, spatial_mesh(["cpu"] * 4),
                                          gossip_rounds=4)
    assert floods == []
    assert flags == int(np.asarray(want_flags).max()) == 0
    assert np.array_equal(labels.numpy(), np.asarray(want))
    dense, dense_flags = turbo.segment_turbo_flagged(torch.from_numpy(img),
                                                     cfg, 2)
    assert dense_flags == 0 and torch.equal(labels, dense)


@pytest.mark.parametrize("mode", list(MODES))
def test_flood_pointer_matches_reference(monkeypatch, mode):
    """GSEG_FLOOD_PTR=1: the root-list rounds resolve their labels on the
    root list; no label flood runs in those rounds."""
    cfg = MODES[mode]
    want = _ref(IMG_PTR, cfg, {"GSEG_FLOOD_PTR": "1"}, monkeypatch)
    monkeypatch.setattr(turbo, "_FLOOD_PTR", True)
    ptr, floods = [], []
    _count_calls(monkeypatch, turbo, "_flood_pointer", ptr)
    _count_calls(monkeypatch, kg, "label_flood", floods)
    labels, flags = _port(IMG_PTR, cfg)
    assert ptr and len(floods) == (2 if mode == "quality" else 0)
    assert flags == want[1] == 0
    assert np.array_equal(labels, want[0])
    assert np.array_equal(labels, _oracle(IMG_PTR, cfg))


def _hook_case(seed, h=23, w=31):
    """A random canonical partition (labels = root pixel ids), a hook graph
    on its components that is functional with 2-cycles (each component
    hooks to one of lower rank or to a partner that hooks back), the hook
    marked on one pixel of each hooking component (pass8, nbrL), id_init,
    and the root list: every root in order, dead slots interleaved and at
    the tail."""
    rng = np.random.default_rng(seed)
    v = h * w
    blocks = rng.integers(0, 12, (h, w)) * 7 + np.arange(w)[None, :] // 6
    L = canonical_min_labels_np(blocks.astype(np.int32))
    roots = np.unique(L)
    rank = rng.permutation(roots.size)
    succ = {}
    for i, r in enumerate(roots):
        lower = [roots[j] for j in range(roots.size) if rank[j] < rank[i]]
        if lower and rng.random() < 0.7:
            succ[int(r)] = int(rng.choice(lower))
    for a in rng.choice(roots, size=min(4, roots.size), replace=False):
        b = succ.get(int(a))
        if b is not None and rng.random() < 0.8:
            succ[b] = int(a)  # a 2-cycle
    pass8 = np.zeros((8, h, w), bool)
    nbrL = rng.integers(0, v, (8, h, w)).astype(np.int32)
    for a, b in succ.items():
        ys, xs = np.nonzero(L == a)
        k = rng.integers(ys.size)
        d = rng.integers(8)
        pass8[d, ys[k], xs[k]] = True
        nbrL[d, ys[k], xs[k]] = b
    id_init = rng.uniform(0, 5, (h, w)).astype(np.float32)
    # every root in order, at increasing slots of a longer list
    cap = roots.size + roots.size // 3 + 5
    rlist = np.full(cap, np.iinfo(np.int32).max, np.int32)
    rlist[np.sort(rng.choice(cap - 3, roots.size, replace=False))] = roots
    return L, id_init, pass8, nbrL, rlist


@pytest.mark.parametrize("seed", range(5))
def test_flood_pointer_function_matches_reference(seed):
    """`_flood_pointer` against the reference's on the same inputs: random
    hook graphs with 2-cycles, a root list with dead slots interleaved and
    at its tail."""
    L, id_init, pass8, nbrL, rlist = _hook_case(seed)
    want = ref_turbo._flood_pointer(*(jnp.asarray(x) for x in (
        L, id_init, pass8, nbrL, rlist)))
    got = turbo._flood_pointer(*(torch.from_numpy(x) for x in (
        L, id_init, pass8, nbrL, rlist)))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] is bool(want[2])


@pytest.mark.parametrize("route", ["nosplit_speed", "nosplit_quality",
                                   "tiers_quality"])
def test_rlist_loop_routes_match_reference(monkeypatch, route):
    """GSEG_RLIST_SPLIT=0 (one loop at full capacity) and
    GSEG_RLIST_TIERS_Q=16,64 (two slices in quality mode), with the slice
    floor shrunk to 64 in both packages so the tiny image slices."""
    kind, mode = route.split("_")
    cfg = MODES[mode]
    if kind == "nosplit":
        env, attr = {"GSEG_RLIST_SPLIT": "0"}, ("_RLIST_SPLIT", False)
    else:
        env, attr = {"GSEG_RLIST_TIERS_Q": "16,64"}, ("_RLIST_TIERS_Q",
                                                      (16, 64))
    monkeypatch.setattr(ref_turbo, "_RLIST_FLOOR", 64)
    monkeypatch.setattr(turbo, "_RLIST_FLOOR", 64)
    want = _ref(IMG_SPLIT, cfg, env, monkeypatch)
    monkeypatch.setattr(turbo, *attr)
    labels, flags = _port(IMG_SPLIT, cfg)
    assert flags == want[1] == 0
    assert np.array_equal(labels, want[0])
    assert np.array_equal(labels, _oracle(IMG_SPLIT, cfg))


@pytest.mark.parametrize("route", ["late_closures_speed",
                                   "no_q_closures_quality"])
def test_closure_routing_matches_reference(monkeypatch, route):
    """GSEG_LATE_CLOSURES=1 (speed mode's root-list rounds on the closure
    route) and GSEG_Q_CLOSURES=0 (quality mode with none): the fixpoints
    get the reference's `closures` arguments (the plain versions, and the
    reference's XLA sweeps on the CPU, take no route), and the labels and
    flags equal the reference's."""
    if route == "late_closures_speed":
        cfg, env = SPEED, {"GSEG_LATE_CLOSURES": "1"}
        attr = ("_LATE_CLOSURES", True)
    else:
        cfg, env = QUALITY, {"GSEG_Q_CLOSURES": "0"}
        attr = ("_Q_CLOSURES", False)
    want = _ref(IMG_PTR, cfg, env, monkeypatch)
    monkeypatch.setattr(turbo, *attr)
    calls = {n: [] for n in ("compmin_gossip", "label_flood", "value_flood")}
    for name, rec in calls.items():
        _count_calls(monkeypatch, kg, name, rec)
    labels, flags = _port(IMG_PTR, cfg)
    routes = {n: [kw.get("closures", False) for kw in c]
              for n, c in calls.items()}
    if route == "late_closures_speed":
        # peel rounds: compmin step-only (round 1 idle); root-list rounds
        # on the closure route; the speed-mode final map step-only
        assert routes["compmin_gossip"][:2] == [False, False]
        assert all(routes["compmin_gossip"][2:]) and all(routes["label_flood"])
        assert routes["label_flood"] and routes["value_flood"] == [False]
    else:
        assert not any(sum(routes.values(), []))
    assert flags == want[1] == 0
    assert np.array_equal(labels, want[0])


@pytest.mark.parametrize("div", [1, 4])
def test_runs_div_matches_reference(monkeypatch, div):
    """GSEG_RUNS_DIV with the runs peel: the run pool's cap is
    max(V / div, 1024); at div 4 the pool overflows on round 1 here and
    the counting scatter sizes the round, as in the reference."""
    img = blobs_image(48, 64, 6, 12.0, 3)
    want = _ref(img, SPEED, {"GSEG_PEEL_SIZES": "runs",
                             "GSEG_RUNS_DIV": str(div)}, monkeypatch)
    monkeypatch.setattr(turbo, "_PEEL_SIZES", "runs")
    monkeypatch.setattr(turbo, "_RUNS_DIV", div)
    caps, ovfs = [], []
    fn = kr.run_extract

    def rec(L, cap):
        out = fn(L, cap)
        caps.append(cap)
        ovfs.append(bool(out[3]))
        return out
    monkeypatch.setattr(kr, "run_extract", rec)
    labels, flags = _port(img, SPEED)
    assert caps == [max(48 * 64 // div, 1024)] * 2
    assert ovfs[0] is (div == 4)
    assert flags == want[1] == 0
    assert np.array_equal(labels, want[0])


@pytest.mark.parametrize("mode", list(MODES))
def test_s2_small_div_matches_reference(monkeypatch, mode):
    """GSEG_S2_SMALL_DIV=1 (a slice as large as the pool, so the full pool
    runs) where the default divisor slices, with the capacity floor shrunk
    in both packages (speed mode: 64, quality: 1024) so the slice is set by
    the divisor."""
    cfg = MODES[mode]
    img = blobs_image(40, 48, 6, 6.0, 7)
    floor = 1024 if mode == "quality" else 64
    monkeypatch.setattr(ref_turbo, "_CAP_FLOOR", floor)
    monkeypatch.setattr(turbo, "_CAP_FLOOR", floor)
    attr = "_S2_SMALL_DIV_Q" if mode == "quality" else "_S2_SMALL_DIV"
    want = _ref(img, cfg, {"GSEG_S2_SMALL_DIV": "1"}, monkeypatch)
    sliced = []
    _count_calls(monkeypatch, turbo, "_slice_pool", sliced)
    default = _port(img, cfg)
    assert len(sliced) == 1  # the default divisor slices here
    monkeypatch.setattr(turbo, attr, 1)
    labels, flags = _port(img, cfg)
    assert len(sliced) == 1
    assert flags == want[1] == default[1] == 0
    assert np.array_equal(labels, want[0])
    assert np.array_equal(labels, default[0])


def test_default_algorithm_is_the_references():
    """No algorithm given: `segment`, `segment_hierarchy` and the CLI run
    the reference's default (atomic) and give its labels byte for byte;
    the configurations' defaults are equal field for field."""
    assert dataclasses.asdict(SegmentationConfig()) == dataclasses.asdict(
        RefConfig())
    img = blobs_image(24, 32, 5, 6.0, 0)
    got = gseg_tpu_torch.segment(img, k=100.0, min_size=8, device="cpu")
    want = np.asarray(gseg_tpu.segment(img, k=100.0, min_size=8))
    assert np.array_equal(got.numpy(), want)
    levels, labels = gseg_tpu_torch.segment_hierarchy(img, k=100.0,
                                                      min_size=8,
                                                      device="cpu")
    r_levels, r_labels = gseg_tpu.segment_hierarchy(img, k=100.0, min_size=8)
    assert np.array_equal(levels.numpy(), np.asarray(r_levels))
    assert np.array_equal(labels.numpy(), np.asarray(r_labels))
    args = ["a", "b"]
    assert cli.build_parser().parse_args(args).algorithm == \
        ref_cli.build_parser().parse_args(args).algorithm == "atomic"


def test_cli_default_labels_equal_reference(tmp_path, capsys):
    """The CLI with no --algorithm: labels byte-equal to the reference
    CLI's."""
    from gseg_tpu_torch.utils import image_io

    img = blobs_image(30, 40, 5, 6.0, 4)
    inp = str(tmp_path / "in.ppm")
    image_io.write_ppm(inp, img)
    args = [inp, "--k", "150", "--min-size", "20", "--labels-out"]
    assert cli.main([args[0], str(tmp_path / "o.ppm"), *args[1:],
                     str(tmp_path / "l.npy"), "--device", "cpu"]) in (0, None)
    assert ref_cli.main([args[0], str(tmp_path / "r.ppm"), *args[1:],
                         str(tmp_path / "r.npy")]) in (0, None)
    capsys.readouterr()
    assert np.array_equal(np.load(tmp_path / "l.npy"),
                          np.load(tmp_path / "r.npy"))

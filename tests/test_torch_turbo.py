"""PyTorch port's turbo path (speed mode) vs the sequential NumPy oracle.

The port runs on the CPU with its plain PyTorch fixpoints and extraction.
Its labels are canonical min-vertex ids, so the partition is compared
exactly against the canonicalized `segment_boruvka_np` oracle, on the cases
of tests/test_turbo.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
from gseg_tpu.models.boruvka_cpu import segment_boruvka_np  # noqa: E402
from gseg_tpu.native import bindings as ref_native  # noqa: E402
from gseg_tpu.ops import filters as jfilters  # noqa: E402
from gseg_tpu.ops import grid_graph as jgg  # noqa: E402
import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops import grid_graph as tgg  # noqa: E402
from gseg_tpu_torch.ops.kernels import extract as kx  # noqa: E402
from gseg_tpu_torch.utils.labels import (  # noqa: E402
    canonical_min_labels_np, num_components)
from gseg_tpu_torch.utils.synthetic import (  # noqa: E402
    blobs_image, checkerboard_image, gradient_image)

CASES = [
    dict(h=24, w=32, k=100.0, min_size=8, connectivity=8, seed=0),
    dict(h=33, w=17, k=300.0, min_size=20, connectivity=8, seed=1),
    dict(h=16, w=16, k=50.0, min_size=1, connectivity=4, seed=2),
    dict(h=1, w=37, k=100.0, min_size=5, connectivity=8, seed=3),
    dict(h=64, w=64, k=200.0, min_size=30, connectivity=8, seed=4),
]


def _oracle(img, cfg):
    ref = RefConfig(**dataclasses.asdict(cfg))
    return canonical_min_labels_np(segment_boruvka_np(img, ref))


def _port(img, cfg, gossip_rounds=2, **kw):
    labels, flags = turbo.segment_turbo_impl(torch.from_numpy(img), cfg,
                                             gossip_rounds, **kw)
    return labels.numpy(), flags


@pytest.mark.parametrize("case", CASES)
def test_partition_matches_oracle(case):
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"],
                             connectivity=case["connectivity"])
    img = blobs_image(case["h"], case["w"], 5, 6.0, case["seed"])
    got, flags = _port(img, cfg)
    assert flags == 0
    assert np.array_equal(_oracle(img, cfg), got)


@pytest.mark.parametrize("gossip_rounds", [1, 2, 6])
def test_gossip_stage2_split_invariant(gossip_rounds):
    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = blobs_image(24, 32, 5, 6.0, 1)
    got, flags = _port(img, cfg, gossip_rounds)
    assert flags == 0
    assert np.array_equal(_oracle(img, cfg), got)


def test_partition_matches_oracle_multistrip():
    """The reference's multi-strip case (96x56, 6 blobs); on the card this
    shape spans 2x3 gossip tiles."""
    cfg = SegmentationConfig(k=200.0, min_size=20, connectivity=8)
    img = blobs_image(96, 56, 6, 6.0, 11)
    got, flags = _port(img, cfg)
    assert flags == 0
    assert np.array_equal(_oracle(img, cfg), got)


def test_rlist_split_loop_matches_oracle(monkeypatch):
    """A small root-list floor makes tiny images run the sliced second
    root-list loop; the partition must not change."""
    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = blobs_image(48, 56, 6, 6.0, 9)
    full, _ = _port(img, cfg)
    monkeypatch.setattr(turbo, "_RLIST_FLOOR", 64)
    sliced, flags = _port(img, cfg)
    assert flags == 0
    assert np.array_equal(full, sliced)
    assert np.array_equal(_oracle(img, cfg), sliced)


@pytest.mark.parametrize("switch", ["_S2_SMALL", "_EX_SMALL"])
def test_small_paths_match_full_capacity(monkeypatch, switch):
    """Both small-path switches are result-invariant: slicing drops only
    dead slots. With the switch on, these shapes take the small branch."""
    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = blobs_image(40, 48, 6, 6.0, 7)
    outs = {}
    for on in (True, False):
        monkeypatch.setattr(turbo, switch, on)
        outs[on] = _port(img, cfg)
    assert outs[True][1] == outs[False][1] == 0
    assert np.array_equal(outs[True][0], outs[False][0])
    assert np.array_equal(_oracle(img, cfg), outs[True][0])


def test_extract_large_count_takes_full_dedup(monkeypatch):
    """Pure noise at k ~ 0: every pixel stays a component, so the extracted
    count exceeds the small slice and the full-capacity dedup runs; both
    switch settings agree, labels and flags."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (96, 100, 3)).astype(np.uint8)
    cfg = SegmentationConfig(k=1e-3, min_size=1, sigma=0.0)
    vid = torch.arange(96 * 100, dtype=torch.int32).reshape(96, 100)
    weights = torch.ones((4, 96, 100))
    for d, (dy, dx) in enumerate(tgg.DIRS4):
        weights[d][~tgg.valid_plane(96, 100, dy, dx)] = torch.inf
    count = int(kx.boundary_extract(vid, weights, 1 << 16)[4])
    assert count > max((1 << 16) // 4, turbo._CAP_FLOOR)
    outs = {}
    for on in (True, False):
        monkeypatch.setattr(turbo, "_EX_SMALL", on)
        outs[on] = _port(img, cfg)
    assert outs[True][1] == outs[False][1] != 0
    assert np.array_equal(outs[True][0], outs[False][0])


def test_capacity_overflow_detected_not_silent():
    """Low-k noise keeps C ~ V into stage 2 and overflows the capacities:
    the flags say so, the checked entry raises, and the fallback returns
    the atomic path's labels, byte-equal to the reference's fallback (k ~ 0
    on continuous noise: every pixel stays its own component)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (192, 384, 3)).astype(np.float32)
    cfg = SegmentationConfig(k=1e-3, min_size=1, sigma=0.0)
    _, flags = _port(img, cfg)
    assert flags & turbo.FLAG_PAIR_OVERFLOW
    assert "capacity" in turbo.describe_flags(flags)
    with pytest.raises(RuntimeError, match="capacity|budget"):
        turbo.segment_turbo(torch.from_numpy(img), cfg)
    fb = dataclasses.replace(cfg, on_overflow="fallback")
    got = turbo.segment_turbo(torch.from_numpy(img), fb)
    want = ref_turbo.segment_turbo(jnp.asarray(img),
                                   RefConfig(**dataclasses.asdict(fb)))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert num_components(got.numpy()) == img.shape[0] * img.shape[1]
    ignored = turbo.segment_turbo(
        torch.from_numpy(img), dataclasses.replace(cfg, on_overflow="ignore"))
    assert ignored.shape == img.shape[:2]


def test_weights_override_from_reference_planes():
    """Both packages fed the reference's weight planes give equal labels."""
    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = blobs_image(24, 40, 5, 6.0, 3)
    smoothed = jfilters.gaussian_smooth(jnp.asarray(img), cfg.sigma)
    weights = np.asarray(jgg.edge_weight_planes(smoothed)[0])
    ref_labels, ref_flags = ref_turbo.segment_turbo_impl(
        jnp.asarray(img), RefConfig(**dataclasses.asdict(cfg)), 2,
        weights_override=jnp.asarray(weights))
    got, flags = _port(img, cfg, weights_override=weights)
    assert flags == int(ref_flags) == 0
    assert np.array_equal(np.asarray(ref_labels), got)
    assert np.array_equal(_port(img, cfg)[0], got)


def test_prune_keeps_minsize_hook_targets():
    """The reference's prune regression: a size-1 frozen outlier must still
    min-size hook into its frozen surroundings."""
    img = np.zeros((24, 32, 3), dtype=np.float32)
    img[:, 16:, 0] = 200.0
    img[12, 8, 2] = 120.0
    cfg = SegmentationConfig(k=50.0, min_size=10, sigma=0.01)
    got, flags = _port(img, cfg)
    sizes = np.bincount(got.reshape(-1))
    assert flags == 0 and (sizes[sizes > 0] >= cfg.min_size).all()
    assert np.array_equal(_oracle(img, cfg), got)


def test_deep_minsize_chain_resolves_in_budget():
    """A min-size hook chain thousands deep resolves by pointer doubling
    within the round budget."""
    n = 4096
    vals = np.cumsum(np.linspace(10.0, 30.0, n)).astype(np.float32)
    img = np.repeat(vals[None, :, None], 3, axis=2).reshape(1, n, 3)
    cfg = SegmentationConfig(k=1e-3, min_size=n, sigma=0.0)
    got, flags = _port(img, cfg)
    assert flags == 0 and num_components(got) == 1
    assert np.array_equal(_oracle(img, cfg), got)


def test_special_images():
    cfg = SegmentationConfig(k=2000.0, min_size=1, sigma=0.4)
    got, _ = _port(gradient_image(20, 20), cfg)
    assert num_components(got) == 1
    cfg = SegmentationConfig(sigma=0.1, k=5.0, min_size=1)
    got, _ = _port(checkerboard_image(24, 24, cell=6), cfg)
    for y in range(0, 24, 6):
        for x in range(0, 24, 6):
            assert np.unique(got[y:y + 6, x:x + 6]).size == 1


def test_segment_api():
    img = blobs_image(24, 32, 5, 6.0, 0)
    cfg = SegmentationConfig(k=100.0, min_size=8, algorithm="turbo")
    labels = gseg_tpu_torch.segment(img, k=100.0, min_size=8,
                                    device="cpu")
    assert labels.dtype == torch.int32 and labels.device.type == "cpu"
    assert np.array_equal(labels.numpy(), _oracle(img, cfg))
    assert np.array_equal(labels.numpy(),
                          canonical_min_labels_np(labels.numpy()))
    # kruskal_native routes to the port's build of the reference's C++
    # baseline: root ids byte-equal to the reference library's
    labels = gseg_tpu_torch.segment(img, k=100.0, min_size=8,
                                    algorithm="kruskal_native", device="cpu")
    assert labels.dtype == torch.int32 and labels.device.type == "cpu"
    assert np.array_equal(labels.numpy(), ref_native.segment_kruskal_native(
        img, RefConfig(k=100.0, min_size=8)))
    # the atomic and fastmst paths are ported: root vertex ids, the oracle
    # partition.
    for algorithm in ("atomic", "fastmst"):
        labels = gseg_tpu_torch.segment(img, k=100.0, min_size=8,
                                        algorithm=algorithm, device="cpu")
        assert np.array_equal(canonical_min_labels_np(labels.numpy()),
                              _oracle(img, cfg))
    # quality mode is ported: weight_buckets=8 gives the bucketed oracle.
    qcfg = dataclasses.replace(cfg, weight_buckets=8)
    labels = gseg_tpu_torch.segment(img, config=qcfg, device="cpu")
    assert np.array_equal(labels.numpy(), _oracle(img, qcfg))


def test_segment_defaults_to_the_gpu(monkeypatch):
    """Without device="cpu" the entry point runs on cuda:0, NumPy image or
    tensor; with no CUDA device it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = blobs_image(24, 32, 5, 6.0, 0)
    for image in (img, torch.from_numpy(img)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            gseg_tpu_torch.segment(image, k=100.0, min_size=8)
    labels = gseg_tpu_torch.segment(torch.from_numpy(img), k=100.0,
                                    min_size=8, device="cpu")
    assert labels.device.type == "cpu"


def test_root_list_and_size_helpers_match_reference():
    """_build_rlist, _component_sizes and _rlist_sizes equal the
    reference's on a random canonical partition and a coarsening of it."""
    rng = np.random.default_rng(9)
    h, w = 17, 23
    blocks = rng.integers(0, 5, (h, w)).astype(np.int32)
    L_old = canonical_min_labels_np(
        blocks * (h * w) + np.arange(h * w).reshape(h, w) // 7)
    L_new = canonical_min_labels_np(L_old // 40)
    S_ref, _ = ref_turbo._component_sizes(jnp.asarray(L_old))
    S_old, ovf = turbo._component_sizes(torch.from_numpy(L_old))
    assert ovf is False and np.array_equal(np.asarray(S_ref), S_old.numpy())
    for cap in (64, 1024):
        r_ref, o_ref = ref_turbo._build_rlist(jnp.asarray(L_old), cap)
        r_got, o_got = turbo._build_rlist(torch.from_numpy(L_old), cap)
        assert np.array_equal(np.asarray(r_ref), r_got.numpy())
        assert bool(o_ref) == bool(o_got)
    rlist, _ = turbo._build_rlist(torch.from_numpy(L_old), 1024)
    S_new, rl_new = turbo._rlist_sizes(rlist, torch.from_numpy(L_new), S_old)
    S_new_ref, rl_ref = ref_turbo._rlist_sizes(
        jnp.asarray(rlist.numpy()), jnp.asarray(L_new), jnp.asarray(S_old))
    assert np.array_equal(np.asarray(S_new_ref), S_new.numpy())
    assert np.array_equal(np.sort(np.asarray(rl_ref)),
                          np.sort(rl_new.numpy()))


def test_pair_dedup_matches_reference():
    """Stage-2 per-pair dedup: the same surviving (src, dst, w, eid)
    entries in the same order, and the same overflow decision."""
    rng = np.random.default_rng(3)
    n = 512
    esrc = rng.integers(0, 30, n).astype(np.int32)
    edst = rng.integers(0, 30, n).astype(np.int32)
    ew = rng.choice(np.float32([0.5, 1.0, 2.5, 7.0, np.inf]), n)
    eid = rng.permutation(n).astype(np.int32)
    for cap in (64, 1024):
        ref = ref_turbo._pair_dedup(*(jnp.asarray(x) for x in
                                      (esrc, edst, ew, eid)), cap)
        got = turbo._pair_dedup(*(torch.from_numpy(x) for x in
                                  (esrc, edst, ew, eid)), cap)
        assert bool(ref[4]) == bool(got[4])
        live = np.isfinite(np.asarray(ref[2]))
        assert np.array_equal(live, np.isfinite(got[2].numpy()))
        for r, g in zip(ref[:4], got[:4]):
            assert np.array_equal(np.asarray(r)[live], g.numpy()[live])

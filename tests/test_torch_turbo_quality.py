"""PyTorch port's turbo quality mode (`weight_buckets > 0`) vs references.

- `bucket_thresholds` bit-equal to the reference's, on weights holding
  +inf (image borders, 4-connectivity's empty diagonals) and on samples
  above and below the 65,536-weight stride.
- Quality-mode labels and flags byte-equal to the reference's
  `segment_turbo_impl` on the CPU (its XLA sweeps), and partitions equal
  to the bucketed `segment_boruvka_np` oracle, on the cases of
  tests/test_turbo.py (weight_buckets 8 and 16) and two more blobs cases.
- One case against the reference's Pallas path in Mosaic's TPU interpret
  mode with `WARM_PASSES` = 0, so its scan-closure kernels run in every
  fixpoint (`closures=True` on both sides).
On the CPU the port runs its plain PyTorch versions; the card runs the
closure route (tests/test_torch_cuda.py, chip_smoke.py). Every comparison
is exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import gseg_tpu  # noqa: E402
from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
from gseg_tpu.models.boruvka_cpu import segment_boruvka_np  # noqa: E402
from gseg_tpu.ops.pallas import gossip as pg  # noqa: E402
import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops import filters  # noqa: E402
from gseg_tpu_torch.ops import grid_graph as tgg  # noqa: E402
from gseg_tpu_torch.utils.labels import canonical_min_labels_np  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

# (h, w, blobs, noise, seed, k, min_size, weight_buckets, connectivity): the
# two of tests/test_turbo.py:51-58, then two more blobs cases.
CASES = [
    (48, 64, 5, 4.0, 1, 30.0, 10, 8, 8),
    (48, 64, 5, 4.0, 1, 30.0, 10, 16, 8),
    (40, 56, 6, 6.0, 3, 100.0, 8, 16, 8),
    (33, 47, 4, 8.0, 9, 300.0, 20, 4, 4),
]


def _ref_cfg(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


def _oracle(img, cfg):
    return canonical_min_labels_np(segment_boruvka_np(img, _ref_cfg(cfg)))


@pytest.mark.parametrize("case", [(24, 40, 8, 0), (300, 300, 16, 1),
                                  (96, 200, 5, 2), (40, 30, 16, 3)])
def test_bucket_thresholds_match_reference(case):
    """Random weights with +inf planes and slots; 300 x 300 x 4 > 65,536
    takes the strided sample."""
    h, w, nb, seed = case
    rng = np.random.default_rng(seed)
    weights = rng.uniform(0, 40, (4, h, w)).astype(np.float32)
    weights[rng.random((4, h, w)) < 0.1] = np.inf
    for d, (dy, dx) in enumerate(tgg.DIRS4):
        weights[d][~tgg.valid_plane(h, w, dy, dx).numpy()] = np.inf
    if seed == 3:
        weights[2:] = np.inf  # 4-connectivity: no diagonal edges
    ref = np.asarray(ref_turbo.bucket_thresholds(jnp.asarray(weights), nb))
    got = turbo.bucket_thresholds(torch.from_numpy(weights), nb)
    assert got.dtype == torch.float32 and got.shape == (nb,)
    assert np.array_equal(ref, got.numpy())
    assert np.isinf(got.numpy()[-1]) and np.isfinite(got.numpy()[:-1]).all()


def test_bucket_thresholds_all_inf():
    weights = torch.full((4, 3, 5), torch.inf)
    ref = ref_turbo.bucket_thresholds(jnp.asarray(weights.numpy()), 4)
    assert np.array_equal(np.asarray(ref),
                          turbo.bucket_thresholds(weights, 4).numpy())


@pytest.mark.parametrize("case", CASES)
def test_quality_mode_matches_reference_and_oracle(case):
    h, w, blobs, noise, seed, k, min_size, wb, conn = case
    cfg = SegmentationConfig(k=k, min_size=min_size, weight_buckets=wb,
                             connectivity=conn)
    img = blobs_image(h, w, blobs, noise, seed)
    ref_labels, ref_flags = ref_turbo.segment_turbo_impl(
        jnp.asarray(img), _ref_cfg(cfg), 2)
    labels, flags = turbo.segment_turbo_impl(torch.from_numpy(img), cfg, 2)
    assert flags == int(ref_flags) == 0
    assert labels.dtype == torch.int32
    assert np.array_equal(np.asarray(ref_labels), labels.numpy())
    assert np.array_equal(_oracle(img, cfg), labels.numpy())


def test_quality_mode_matches_pallas_closure_path(monkeypatch):
    """The reference's Pallas path with every fixpoint on the closure
    route from its first pass (WARM_PASSES = 0)."""
    monkeypatch.setattr(ref_turbo, "_use_pallas", lambda: True)
    monkeypatch.setattr(pg, "WARM_PASSES", 0)
    cfg = SegmentationConfig(k=100.0, min_size=8, weight_buckets=16)
    img = blobs_image(24, 40, 5, 6.0, 7)
    with pltpu.force_tpu_interpret_mode():
        ref_labels, ref_flags = ref_turbo.segment_turbo_impl(
            jnp.asarray(img), _ref_cfg(cfg), 2)
    labels, flags = turbo.segment_turbo_impl(torch.from_numpy(img), cfg, 2)
    assert flags == int(ref_flags) == 0
    assert np.array_equal(np.asarray(ref_labels), labels.numpy())
    assert np.array_equal(_oracle(img, cfg), labels.numpy())


def test_segment_api_quality_mode():
    """A config's default algorithm is the port's "turbo": quality mode runs
    from the config alone; a config naming "atomic" with weight buckets is
    refused as the reference refuses it (that path ignores them), as is one
    naming "fastmst"; one naming "kruskal_native" is not (the C++ baseline
    takes the edges in sorted order, so the ramp is moot) and gives the
    reference's labels byte for byte."""
    img = blobs_image(48, 64, 5, 4.0, 1)
    cfg = SegmentationConfig(k=30.0, min_size=10, weight_buckets=16)
    labels = gseg_tpu_torch.segment(img, config=cfg, device="cpu")
    assert labels.dtype == torch.int32 and labels.device.type == "cpu"
    assert np.array_equal(labels.numpy(), _oracle(img, cfg))
    for algorithm in ("atomic", "fastmst"):
        with pytest.raises(ValueError, match="weight_buckets=16"):
            gseg_tpu_torch.segment(img, config=dataclasses.replace(
                cfg, algorithm=algorithm), device="cpu")
    native = dataclasses.replace(cfg, algorithm="kruskal_native")
    labels = gseg_tpu_torch.segment(img, config=native, device="cpu")
    assert np.array_equal(labels.numpy(), np.asarray(
        gseg_tpu.segment(img, config=_ref_cfg(native))))


@pytest.mark.parametrize("gossip_rounds", [1, 4])
def test_quality_handoff_split_invariant(gossip_rounds):
    """Where stage G hands off (the bucket position travels with it) does
    not change the partition."""
    cfg = SegmentationConfig(k=30.0, min_size=10, weight_buckets=16)
    img = blobs_image(48, 64, 5, 4.0, 1)
    labels, flags = turbo.segment_turbo_impl(torch.from_numpy(img), cfg,
                                             gossip_rounds)
    assert flags == 0
    assert np.array_equal(_oracle(img, cfg), labels.numpy())


def test_quality_sliced_root_list_matches_oracle(monkeypatch):
    """A small root-list floor makes the quality rounds reach the sliced
    root-list tier (V/16); the partition must not change."""
    cfg = SegmentationConfig(k=30.0, min_size=10, weight_buckets=16)
    img = blobs_image(48, 64, 5, 4.0, 1)
    full, _ = turbo.segment_turbo_impl(torch.from_numpy(img), cfg, 2)
    monkeypatch.setattr(turbo, "_RLIST_FLOOR", 64)
    sliced, flags = turbo.segment_turbo_impl(torch.from_numpy(img), cfg, 2)
    assert flags == 0
    assert torch.equal(full, sliced)


def test_quality_weights_override_from_reference_planes():
    """Both packages fed the reference-side weight planes of the port's
    filters give equal labels in quality mode."""
    cfg = SegmentationConfig(k=100.0, min_size=8, weight_buckets=16)
    img = blobs_image(40, 56, 6, 6.0, 3)
    weights = tgg.edge_weight_planes(filters.gaussian_smooth(
        torch.from_numpy(img), cfg.sigma))[0].numpy()
    ref_labels, ref_flags = ref_turbo.segment_turbo_impl(
        jnp.asarray(img), _ref_cfg(cfg), 2, weights_override=jnp.asarray(
            weights))
    labels, flags = turbo.segment_turbo_impl(torch.from_numpy(img), cfg, 2,
                                             weights_override=weights)
    assert flags == int(ref_flags) == 0
    assert np.array_equal(np.asarray(ref_labels), labels.numpy())

"""The port's atomic path and public `segment` dispatch against `gseg_tpu`,
on the CPU, with images made from a numpy seed.

Labels are root vertex ids, compared byte for byte (not canonically) with
the reference's `segment_atomic`, `segment_atomic_hostsync` and
`segment_atomic_hierarchy` (levels and final map) on the cases of
tests/test_atomic_boruvka.py: the blob cases (a 1-row image, 4- and
8-connectivity), quantized weights and flat images; on a checkerboard at
sigma 0.1 (subnormal weights, see the test) against the reference's NumPy
oracle, and canonically against its jax path. The same labels equal the
port's NumPy Boruvka oracle's. `segment` routes
turbo, atomic, atomic_hostsync, boruvka_cpu and kruskal_cpu to labels
byte-equal to the reference's `segment` (fastmst and superpixel too),
refuses weight_buckets where the reference does, and routes
kruskal_native to the port's build of the reference's C++ baseline.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gseg_tpu  # noqa: E402
from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import atomic_boruvka as ra  # noqa: E402
from gseg_tpu.models.boruvka_cpu import (  # noqa: E402
    segment_boruvka_np as ref_boruvka_np)
import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import atomic_boruvka as ta  # noqa: E402
from gseg_tpu_torch.models.boruvka_cpu import segment_boruvka_np  # noqa: E402
from gseg_tpu_torch.utils.labels import (  # noqa: E402
    canonical_min_labels_np, num_components)
from gseg_tpu_torch.utils.synthetic import (  # noqa: E402
    blobs_image, checkerboard_image, gradient_image)

CASES = [
    dict(h=24, w=32, k=100.0, min_size=8, connectivity=8, seed=0),
    dict(h=33, w=17, k=300.0, min_size=20, connectivity=8, seed=1),
    dict(h=16, w=16, k=50.0, min_size=1, connectivity=4, seed=2),
    dict(h=1, w=37, k=100.0, min_size=5, connectivity=8, seed=3),
    dict(h=40, w=8, k=150.0, min_size=2, connectivity=8, seed=4),
]


def _ref(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


def _port(img, cfg):
    return ta.segment_atomic(torch.from_numpy(img), cfg).numpy()


@pytest.mark.parametrize("case", CASES)
def test_atomic_byte_equal_to_reference(case):
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"],
                             connectivity=case["connectivity"],
                             algorithm="atomic")
    img = blobs_image(case["h"], case["w"], 5, 6.0, case["seed"])
    want = np.asarray(ra.segment_atomic(jnp.asarray(img), _ref(cfg)))
    got = _port(img, cfg)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(want, got)
    assert np.array_equal(segment_boruvka_np(img, cfg), got)


@pytest.mark.parametrize("case", [CASES[0], CASES[1]])
def test_every_round_state_byte_equal_to_reference(case):
    """Each round's whole state, every slot of parent, size and Int, the
    non-root slots included, equals the reference round's: the rounds
    scatter only the lanes that can change a slot, and leave the others'
    slots as the reference's do."""
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"],
                             connectivity=case["connectivity"],
                             algorithm="atomic")
    img = blobs_image(case["h"], case["w"], 5, 6.0, case["seed"])
    shape = (case["h"], case["w"])
    rw8, reid8 = ra.prepare_graph(jnp.asarray(img), _ref(cfg))
    tw8, teid8 = ta.prepare_graph(torch.from_numpy(img), cfg)
    ref = ra._init_state(shape[0] * shape[1])
    got = ta._init_state(shape[0] * shape[1], "cpu")
    rounds = 0
    for mode in ("felz", "minsize"):
        for _ in range(cfg.max_iters):
            ref = ra._one_round_jit(ref, rw8, reid8, shape, _ref(cfg), mode)
            got = ta._round(got, tw8, teid8, shape, cfg.k, cfg.min_size,
                            mode)
            rounds += 1
            for name in ("parent", "size", "intdiff"):
                want = np.asarray(getattr(ref, name))
                have = getattr(got, name).numpy()
                assert want.dtype == have.dtype
                assert np.array_equal(want.view(np.int32),
                                      have.view(np.int32)), (mode, name)
            assert bool(ref.merged) == got.merged
            if not got.merged:
                break
    assert rounds > 2


def test_quantized_weights_byte_equal():
    cfg = SegmentationConfig(k=100.0, min_size=8, quantize_weight_bits=12)
    img = blobs_image(24, 32, 5, 6.0, 0)
    want = np.asarray(ra.segment_atomic(jnp.asarray(img), _ref(cfg)))
    assert np.array_equal(want, _port(img, cfg))


def test_hostsync_byte_equal():
    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = blobs_image(24, 32, 5, 6.0, 0)
    want = np.asarray(ra.segment_atomic_hostsync(img, _ref(cfg)))
    got = ta.segment_atomic_hostsync(img, cfg)
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(want, got.numpy())
    assert np.array_equal(got.numpy(), _port(img, cfg))


@pytest.mark.parametrize("case", [CASES[0], CASES[3]])
def test_hierarchy_byte_equal_and_nested(case):
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"],
                             connectivity=case["connectivity"])
    img = blobs_image(case["h"], case["w"], 5, 6.0, case["seed"])
    r_levels, r_final = ra.segment_atomic_hierarchy(jnp.asarray(img),
                                                    _ref(cfg))
    levels, final = ta.segment_atomic_hierarchy(torch.from_numpy(img), cfg)
    assert levels.shape == (cfg.max_iters + 1, case["h"], case["w"])
    assert np.array_equal(np.asarray(r_levels), levels.numpy())
    assert np.array_equal(np.asarray(r_final), final.numpy())
    levels = levels.numpy().reshape(levels.shape[0], -1)
    assert np.array_equal(levels[0], np.arange(levels.shape[1]))
    for fine, coarse in zip(levels[:-1], levels[1:]):
        pairs = np.unique(np.stack([fine, coarse], 1), axis=0)
        assert np.unique(pairs[:, 0]).size == pairs.shape[0]


def test_checkerboard_and_flat_images():
    """At sigma 0.1 the checkerboard's cell borders give squared colour
    differences below float32's smallest normal number; XLA:CPU flushes
    them to 0 where NumPy and torch keep them, so tied weights break
    differently and the root ids (not the partition) differ from the
    reference's jax path. They equal its NumPy oracle's, byte for byte."""
    cfg = SegmentationConfig(sigma=0.1, k=5.0, min_size=1)
    img = checkerboard_image(24, 24, cell=6)
    got = _port(img, cfg)
    assert np.array_equal(ref_boruvka_np(img, _ref(cfg)), got)
    assert np.array_equal(
        canonical_min_labels_np(np.asarray(
            ra.segment_atomic(jnp.asarray(img), _ref(cfg)))),
        canonical_min_labels_np(got))
    for y in range(0, 24, 6):
        for x in range(0, 24, 6):
            assert np.unique(got[y:y + 6, x:x + 6]).size == 1
    flat = np.full((8, 12, 3), 99, np.uint8)
    assert num_components(_port(flat, SegmentationConfig(k=10.0,
                                                         min_size=1))) == 1
    assert num_components(_port(gradient_image(12, 12), SegmentationConfig(
        k=2000.0, min_size=1))) == 1


@pytest.mark.parametrize("algorithm", [
    "turbo", "atomic", "atomic_hostsync", "boruvka_cpu", "kruskal_cpu"])
def test_segment_dispatch_byte_equal(algorithm):
    img = blobs_image(24, 32, 5, 6.0, 0)
    want = np.asarray(gseg_tpu.segment(img, k=100.0, min_size=8,
                                       algorithm=algorithm))
    got = gseg_tpu_torch.segment(img, k=100.0, min_size=8,
                                 algorithm=algorithm, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("algorithm", [
    "atomic", "atomic_hostsync", "fastmst", "superpixel"])
def test_weight_buckets_refused_where_ignored(algorithm):
    img = blobs_image(8, 8, 2, 6.0, 0)
    cfg = SegmentationConfig(weight_buckets=16, algorithm=algorithm)
    with pytest.raises(ValueError, match="weight_buckets=16"):
        gseg_tpu.segment(img, config=_ref(cfg))
    for entry in (gseg_tpu_torch.segment, gseg_tpu_torch.segment_hierarchy):
        with pytest.raises(ValueError, match="weight_buckets=16"):
            entry(img, config=cfg, device="cpu")
    for ok in ("turbo", "boruvka_cpu", "kruskal_cpu"):  # honored or moot
        gseg_tpu_torch.segment(
            img, config=dataclasses.replace(cfg, algorithm=ok), device="cpu")


@pytest.mark.parametrize("algorithm", [
    "fastmst", "superpixel", "kruskal_native"])
def test_unported_routes_cite_their_roadmap_item(algorithm):
    """Every route is ported now: fastmst, superpixel and the C++
    kruskal_native baseline route to labels byte-equal to the
    reference's."""
    img = blobs_image(8, 8, 2, 6.0, 0)
    want = gseg_tpu.segment(img, algorithm=algorithm)
    got = gseg_tpu_torch.segment(img, algorithm=algorithm, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got.numpy())

"""The port's turbo hierarchy and `segment_hierarchy` against `gseg_tpu`, on
the CPU, with images made from a numpy seed.

`segment_turbo_hierarchy_flagged` gives levels, final labels and flags
byte-equal to the reference's (its XLA sweeps on the CPU) at 24x32, at the
reference's multi-strip shape (96x56), at 20x28 with max_iters 12, in
quality mode (weight_buckets=16), and with fewer levels than stage-G
rounds (only gossip levels, the last slot overwritten). Level 0 is the
identity and every level nests in the next. `segment_hierarchy` routes
turbo, atomic, atomic_hostsync and boruvka_cpu to the reference's results,
byte for byte (fastmst and superpixel too); the checked entry's overflow
fallback returns the fastmst hierarchy, byte-equal to the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import gseg_tpu  # noqa: E402
from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

CASES = {
    "24x32": (blobs_image(24, 32, 5, 6.0, 0),
              SegmentationConfig(k=100.0, min_size=8)),
    "multistrip-96x56": (blobs_image(96, 56, 6, 6.0, 11),
                         SegmentationConfig(k=200.0, min_size=20)),
    "20x28-max_iters12": (blobs_image(20, 28, 4, 5.0, 3),
                          SegmentationConfig(k=120.0, min_size=1,
                                             max_iters=12)),
    "24x32-wb16": (blobs_image(24, 32, 5, 6.0, 0),
                   SegmentationConfig(k=100.0, min_size=8,
                                      weight_buckets=16)),
}


def _ref(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


def _nested(levels):
    flat = levels.reshape(levels.shape[0], -1)
    assert np.array_equal(flat[0], np.arange(flat.shape[1]))
    for fine, coarse in zip(flat[:-1], flat[1:]):
        pairs = np.unique(np.stack([fine, coarse], 1), axis=0)
        assert np.unique(pairs[:, 0]).size == pairs.shape[0]


@pytest.mark.parametrize("name", list(CASES))
def test_turbo_hierarchy_byte_equal(name):
    img, cfg = CASES[name]
    r_levels, r_labels, r_flags = ref_turbo.segment_turbo_hierarchy_flagged(
        jnp.asarray(img), _ref(cfg))
    levels, labels, flags = turbo.segment_turbo_hierarchy_flagged(
        torch.from_numpy(img), cfg)
    assert flags == int(r_flags) == 0
    assert levels.shape == (cfg.max_iters + 1, *img.shape[:2])
    assert np.array_equal(np.asarray(r_levels), levels.numpy())
    assert np.array_equal(np.asarray(r_labels), labels.numpy())
    _nested(levels.numpy())
    # the final map is segment_turbo's
    assert np.array_equal(turbo.segment_turbo_flagged(
        torch.from_numpy(img), cfg)[0].numpy(), labels.numpy())


def test_turbo_hierarchy_fewer_levels_than_rounds():
    """n_levels below stage G's round count: every level comes from the
    gossip capture, and later rounds overwrite the last slot."""
    img, cfg = CASES["24x32"]
    r = ref_turbo.segment_turbo_hierarchy_flagged(jnp.asarray(img),
                                                  _ref(cfg), 2, 2)
    levels, labels, flags = turbo.segment_turbo_hierarchy_flagged(
        torch.from_numpy(img), cfg, 2, 2)
    assert levels.shape[0] == 3 and flags == int(r[2])
    assert np.array_equal(np.asarray(r[0]), levels.numpy())
    assert np.array_equal(np.asarray(r[1]), labels.numpy())


@pytest.mark.parametrize("algorithm", [
    "turbo", "atomic", "atomic_hostsync", "boruvka_cpu"])
def test_segment_hierarchy_dispatch_byte_equal(algorithm):
    img, cfg = CASES["24x32"]
    cfg = dataclasses.replace(cfg, algorithm=algorithm)
    r_levels, r_labels = gseg_tpu.segment_hierarchy(img, config=_ref(cfg))
    levels, labels = gseg_tpu_torch.segment_hierarchy(img, config=cfg,
                                                      device="cpu")
    assert levels.device.type == labels.device.type == "cpu"
    assert levels.dtype == labels.dtype == torch.int32
    assert np.array_equal(np.asarray(r_levels), levels.numpy())
    assert np.array_equal(np.asarray(r_labels), labels.numpy())


def test_segment_hierarchy_refuses_what_the_reference_refuses():
    """The Kruskal routes have no hierarchy mode; fastmst and superpixel
    route to hierarchies byte-equal to the reference's."""
    img = blobs_image(8, 8, 2, 6.0, 0)
    for algorithm in ("fastmst", "superpixel"):
        want = gseg_tpu.segment_hierarchy(img, algorithm=algorithm)
        got = gseg_tpu_torch.segment_hierarchy(img, algorithm=algorithm,
                                               device="cpu")
        for w, g in zip(want, got, strict=True):
            assert np.array_equal(np.asarray(w), g.numpy())
    for algorithm in ("kruskal_cpu", "kruskal_native"):
        with pytest.raises(ValueError, match="no hierarchy mode"):
            gseg_tpu_torch.segment_hierarchy(img, algorithm=algorithm,
                                             device="cpu")


def test_turbo_hierarchy_overflow_routes(monkeypatch):
    """A flagged hierarchy raises, returns anyway under "ignore", and falls
    back to the fastmst hierarchy (n_levels + 2 planes, root ids),
    byte-equal to the reference's fallback."""
    img, cfg = CASES["20x28-max_iters12"]
    levels, labels, _ = turbo.segment_turbo_hierarchy_flagged(
        torch.from_numpy(img), cfg)
    ref_flagged = ref_turbo.segment_turbo_hierarchy_flagged
    monkeypatch.setattr(turbo, "segment_turbo_hierarchy_flagged",
                        lambda *a: (levels, labels,
                                    turbo.FLAG_PAIR_OVERFLOW))
    monkeypatch.setattr(ref_turbo, "segment_turbo_hierarchy_flagged",
                        lambda *a: (*ref_flagged(*a)[:2],
                                    ref_turbo.FLAG_PAIR_OVERFLOW))
    x = torch.from_numpy(img)
    with pytest.raises(RuntimeError, match="pair-extraction"):
        turbo.segment_turbo_hierarchy(x, cfg)
    fb = dataclasses.replace(cfg, on_overflow="fallback")
    want = ref_turbo.segment_turbo_hierarchy(jnp.asarray(img), _ref(fb))
    got = turbo.segment_turbo_hierarchy(x, fb)
    assert got[0].shape == (cfg.max_iters + 2, *img.shape[:2])
    for w, g in zip(want, got, strict=True):
        assert np.array_equal(np.asarray(w), g.numpy())
    got = turbo.segment_turbo_hierarchy(
        x, dataclasses.replace(cfg, on_overflow="ignore"))
    assert got[0] is levels and got[1] is labels

"""The port's row-sharded turbo path (`parallel.turbo_spatial`) and the
spatial fixpoints of `ops.kernels.gossip`, on CPU meshes.

`segment_turbo_spatial` must give the dense `segment_turbo`'s labels and
flags byte for byte (and, in one speed-mode case, the reference's
`gseg_tpu.parallel.turbo_spatial` on the 8-device virtual CPU mesh of
tests/conftest.py). Each spatial fixpoint must reach the dense plain
fixpoint and its `unconverged` flag exactly, on the CPU's one-row halo
sweep and on the slab route the card takes (T = 8 exchanged rows a pass),
driven here by `step_pass_plain`, with tiles shorter than T.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.parallel import spatial as ref_spatial  # noqa: E402
from gseg_tpu.parallel import turbo_spatial as ref_ts  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops import grid_graph as gg  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402
from gseg_tpu_torch.parallel import mesh  # noqa: E402
from gseg_tpu_torch.parallel.spatial import spatial_mesh  # noqa: E402
from gseg_tpu_torch.parallel.turbo_spatial import (  # noqa: E402
    segment_turbo_spatial)
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

needs_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices")

# (image, config, ranks, gossip_rounds of both paths): the reference's
# tests/test_parallel.py cases
CASES = {
    "speed_48x40_8": (blobs_image(48, 40, 5, 6.0, 2),
                      SegmentationConfig(k=120.0, min_size=8), 8, (4, 2)),
    "quality_48x40_8": (blobs_image(48, 40, 5, 6.0, 3),
                        SegmentationConfig(k=30.0, min_size=10,
                                           weight_buckets=16), 8, (4, 4)),
    "minsize_64x24_4": (blobs_image(64, 24, 6, 8.0, 5),
                        SegmentationConfig(k=60.0, min_size=20), 4, (4, 2)),
}
PLAIN = {"compmin": kg.compmin_gossip_plain,
         "labeldist": kg.label_gossip_plain,
         "labelnd": kg.label_flood_plain, "value": kg.value_flood_plain,
         "subsum": kg.subtree_sums_plain}
SPATIAL = {"compmin": kg.compmin_gossip_spatial,
           "labeldist": kg.label_gossip_spatial,
           "labelnd": kg.label_flood_spatial,
           "value": kg.value_flood_spatial,
           "subsum": kg.subtree_sums_spatial}


@pytest.mark.parametrize("case", list(CASES))
def test_turbo_spatial_equals_dense(case):
    img, cfg, n, (rounds, dense_rounds) = CASES[case]
    labels, flags = segment_turbo_spatial(img, cfg,
                                          spatial_mesh(["cpu"] * n),
                                          gossip_rounds=rounds)
    dense, dense_flags = turbo.segment_turbo_flagged(
        torch.from_numpy(img), cfg, dense_rounds)
    assert flags == dense_flags == 0
    assert labels.dtype == torch.int32
    assert torch.equal(labels, dense)


@needs_devices
def test_turbo_spatial_equals_reference():
    img, cfg, n, (rounds, _) = CASES["speed_48x40_8"]
    import dataclasses

    want, want_flags = ref_ts.segment_turbo_spatial(
        jnp.asarray(img), RefConfig(**dataclasses.asdict(cfg)),
        ref_spatial.spatial_mesh(jax.devices()[:n]), gossip_rounds=rounds)
    labels, flags = segment_turbo_spatial(img, cfg,
                                          spatial_mesh(["cpu"] * n),
                                          gossip_rounds=rounds)
    assert flags == int(want_flags) == 0
    assert np.array_equal(labels.numpy(), np.asarray(want))


def test_turbo_spatial_errors():
    cfg = SegmentationConfig(k=120.0, min_size=8)
    m = spatial_mesh(["cpu"] * 8)
    with pytest.raises(ValueError, match="not divisible"):
        segment_turbo_spatial(blobs_image(44, 40, 5, 6.0, 0), cfg, m)
    with pytest.raises(ValueError, match="halo"):
        segment_turbo_spatial(blobs_image(32, 40, 5, 6.0, 0), cfg, m)


def _record_inputs(img, cfg):
    """The first call's (read-only plane, fields) of each fixpoint in one
    dense turbo run (compmin's first non-idle one)."""
    got = {}

    def wrap(variant, fn, nf):
        def rec(ro, *args, **kw):
            if variant not in got and not kw.get("idle", False):
                got[variant] = (ro.clone(), [x.clone() for x in args[:nf]])
            return fn(ro, *args, **kw)
        return rec

    originals = {"compmin": (kg.compmin_gossip, 3),
                 "labeldist": (kg.label_gossip, 3),
                 "labelnd": (kg.label_flood, 2),
                 "value": (kg.value_flood, 1),
                 "subsum": (kg.subtree_sums, 1)}
    names = {"compmin": "compmin_gossip", "labeldist": "label_gossip",
             "labelnd": "label_flood", "value": "value_flood",
             "subsum": "subtree_sums"}
    try:
        for v, (fn, nf) in originals.items():
            setattr(kg, names[v], wrap(v, fn, nf))
        turbo.segment_turbo_flagged(torch.from_numpy(img), cfg, 2)
    finally:
        for v, (fn, _) in originals.items():
            setattr(kg, names[v], fn)
    assert set(got) == set(originals)
    return got


@pytest.fixture(scope="module")
def fixpoint_inputs():
    """Main-path fixpoint inputs at 48x40 (8 ranks: 6-row tiles) and
    18x40 (3 ranks: 6-row tiles), both shorter than T = 8."""
    cfg = SegmentationConfig(k=120.0, min_size=8)
    return {(48, 8): _record_inputs(blobs_image(48, 40, 5, 6.0, 2), cfg),
            (18, 3): _record_inputs(blobs_image(18, 40, 3, 6.0, 4), cfg)}


def _spatial(variant, ro, fields, n, max_sweeps, step):
    tiles = list(zip(ro.split(ro.shape[0] // n),
                     *[x.split(ro.shape[0] // n) for x in fields]))

    def run(rank, tile):
        return SPATIAL[variant](tile[0], *tile[1:], max_sweeps, rank,
                                step=step)

    out = mesh.run_ranks(["cpu"] * n, run, tiles)
    assert all(o[-1] is out[0][-1] for o in out)
    return [torch.cat([o[f] for o in out]) for f in range(len(fields))], \
        out[0][-1]


@pytest.mark.parametrize("variant", list(PLAIN))
@pytest.mark.parametrize("shape", [(48, 8), (18, 3)])
@pytest.mark.parametrize("route", ["sweep", "slab"])
def test_spatial_fixpoint_equals_dense(fixpoint_inputs, variant, shape,
                                       route):
    """Each variant's spatial fixpoint gives the dense plain fixpoint and
    its unconverged flag exactly, on the CPU's sweep and on the slab route
    with step_pass_plain as its pass."""
    h, n = shape
    ro, fields = fixpoint_inputs[shape][variant]
    ms = 4 * (h + 40)
    *want, want_unconv = PLAIN[variant](ro, *fields, ms)
    step = kg.step_pass_plain if route == "slab" else None
    got, unconv = _spatial(variant, ro, fields, n, ms, step)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert unconv is want_unconv is False


def test_subsum_tree_crosses_tiles(fixpoint_inputs):
    """The subsum case above has parents across tile borders: some pixel on
    a tile's first row has its parent in the row above (a tile of the rank
    before)."""
    pdir = fixpoint_inputs[(48, 8)]["subsum"][0]
    up = {d for d, (dy, _) in enumerate(gg.DIRS8) if dy == -1}
    first_rows = pdir[6::6]
    assert any(bool((first_rows == d).any()) for d in up)


def _long_range_inputs(variant, h=48, w=40):
    """Inputs whose fixpoint needs far more than T sweeps: one component
    over the whole plane, values flooding from a corner; subsum a chain
    tree (each row's pixels point west, column 0 north) of depth h + w - 2."""
    rng = np.random.default_rng(1)
    L = torch.zeros((h, w), dtype=torch.int32)
    vid = torch.arange(h * w, dtype=torch.int32).reshape(h, w)
    allow = kg.pack_allow_bits([gg.shift_plane(L, dy, dx, -1) == L
                                for dy, dx in gg.DIRS8])
    idf = torch.from_numpy(rng.uniform(0, 5, (h, w)).astype(np.float32))
    if variant == "compmin":
        return L, [torch.from_numpy(rng.uniform(0, 1, (h, w))
                                    .astype(np.float32)), vid.flip(0),
                   torch.from_numpy(rng.integers(1, 9, (h, w))
                                    .astype(np.int32))]
    if variant == "value":
        return L, [vid]
    if variant == "labelnd":
        return allow, [vid, idf]
    if variant == "labeldist":
        return allow, [vid, idf, torch.full_like(vid, kg.BIGDIST).masked_fill(
            vid == 0, 0)]
    pdir = torch.full((h, w), 4, dtype=torch.int32)  # west
    pdir[1:, 0] = 5  # north
    pdir[0, 0] = 8
    return pdir, [torch.ones_like(pdir)]


@pytest.mark.parametrize("variant", list(PLAIN))
def test_spatial_fixpoint_cap_flags_unconverged(variant):
    """A sweep cap that ends the loop early: the sweep route gives the
    capped plain result and unconverged=True; the slab route (T sweeps a
    pass, ceil(3 / T) = 1 pass) the plain result after T sweeps,
    unconverged too."""
    ro, fields = _long_range_inputs(variant)
    for cap, step, sweeps in ((3, None, 3), (3, kg.step_pass_plain,
                                             kg.STEPS)):
        *want, unconv = PLAIN[variant](ro, *fields, sweeps)
        got, got_unconv = _spatial(variant, ro, fields, 8, cap, step)
        assert unconv is got_unconv is True
        assert all(torch.equal(a, b) for a, b in zip(got, want))

"""The port's superpixel hierarchy against `gseg_tpu`, on the CPU, with images
made from a numpy seed.

Levels, the final level, single levels 0, 1, 3 and 4 of
`segment_superpixel` and flags are byte-equal to the reference's jitted
entries at 24x32 and 20x24. At the multi-chunk shape 260x300 the
reference's jitted smoothing and Sobel filters drift in the last bits (XLA
fuses them, ROADMAP §3), so there the port is held to the reference run
without its outer jit, as the level oracle is made; its compact rounds
are compiled either way. The two sums that decide the weights' bits are
held on their own: the colour sums, bit-equal after round 1 and after a
compact round (`ordered_scatter_add` adds in index order, as XLA:CPU's
scatter does), and the round's colour distance, bit-equal to XLA:CPU's
compiled arithmetic (a chain of fused multiply-adds), which op-by-op
float32 arithmetic is not. The port's NumPy spec `superpixel_hierarchy_np`
equals the reference's. The checked entries' `on_overflow` routes (flags
monkeypatched) and the public dispatch route as the reference's do.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gseg_tpu  # noqa: E402
from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import fastmst_np as rnp  # noqa: E402
from gseg_tpu.models import superpixel as rsp  # noqa: E402
import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import fastmst_np as tnp  # noqa: E402
from gseg_tpu_torch.models import superpixel as tsp  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops.kernels import scatter as ks  # noqa: E402
from gseg_tpu_torch.utils.labels import canonical_min_labels_np  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

CASES = {
    "24x32": (blobs_image(24, 32, 4, 5.0, 0),
              SegmentationConfig(k=100.0, min_size=1, max_iters=16,
                                 algorithm="superpixel")),
    "20x24": (blobs_image(20, 24, 4, 5.0, 1),
              SegmentationConfig(k=100.0, min_size=1,
                                 algorithm="superpixel")),
}


def _ref(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", list(CASES))
def test_hierarchy_byte_equal(name):
    img, cfg = CASES[name]
    r_levels, r_final, r_flags = rsp.segment_superpixel_hierarchy_flagged(
        jnp.asarray(img), _ref(cfg))
    levels, final, flags = tsp.segment_superpixel_hierarchy_flagged(
        torch.from_numpy(img), cfg)
    assert levels.dtype == torch.int32
    assert levels.shape == (max(cfg.max_iters, 2) + 1, *img.shape[:2])
    assert np.array_equal(np.asarray(r_levels), levels.numpy())
    assert np.array_equal(np.asarray(r_final), final.numpy())
    assert flags == int(r_flags) == 0
    counts = [np.unique(lv).size for lv in levels.numpy()]
    assert counts[0] == img.shape[0] * img.shape[1] and counts[-1] == 1
    assert all(a >= b for a, b in zip(counts, counts[1:]))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("level", [0, 1, 3, 4])
def test_single_levels_byte_equal(name, level):
    img, cfg = CASES[name]
    cfg = dataclasses.replace(cfg, hierarchy_levels=level)
    want, wflags = rsp.segment_superpixel_flagged(jnp.asarray(img), _ref(cfg))
    got, flags = tsp.segment_superpixel_flagged(torch.from_numpy(img), cfg)
    assert got.dtype == torch.int32 and flags == int(wflags) == 0
    assert np.array_equal(np.asarray(want), got.numpy())


@functools.lru_cache(maxsize=None)
def _multichunk():
    img = blobs_image(260, 300, num_blobs=8, noise=8.0, seed=5)
    cfg = SegmentationConfig(k=150.0, min_size=1, max_iters=12)
    levels, final, flags = rsp.segment_superpixel_hierarchy_impl(
        jnp.asarray(img), _ref(cfg))
    assert int(flags) == 0
    return img, cfg, np.asarray(levels)


def test_multichunk_hierarchy_byte_equal():
    img, cfg, want = _multichunk()
    assert 4 * img.shape[0] * img.shape[1] > 131072  # several chunks
    levels, final, flags = tsp.segment_superpixel_hierarchy_flagged(
        torch.from_numpy(img), cfg)
    assert flags == 0 and np.array_equal(want, levels.numpy())
    assert torch.equal(final, levels[-1])


@pytest.mark.parametrize("level", [0, 1, 3, 4])
def test_multichunk_single_levels_byte_equal(level):
    """hierarchy_levels 0 selects the default level, 4."""
    img, cfg, want = _multichunk()
    got, flags = tsp.segment_superpixel_flagged(
        torch.from_numpy(img), dataclasses.replace(cfg,
                                                   hierarchy_levels=level))
    assert flags == 0 and np.array_equal(want[level or 4], got.numpy())


def _round1(img, cfg):
    """The reference's round 1 and handoff, op by op, and the port's."""
    L1, size1, csum1, strength, merged1, _ = rsp._round1_dense(
        jnp.asarray(img), _ref(cfg))
    x = rsp._extract_compact(L1, strength, img.shape[0] * img.shape[1])
    ref = rsp.SPCompact(esrc=x[0], edst=x[1], estr=x[2], eeid=x[3],
                        SZf=size1, CSf=csum1, fin=x[4], merged=merged1,
                        it=jnp.int32(0), flags=x[7])
    L1, size1, csum1, strength, merged1 = tsp._round1_dense(
        torch.from_numpy(img), cfg)
    x = tsp._extract_compact(L1, strength, img.shape[0] * img.shape[1])
    got = tsp.SPCompact(esrc=x[0], edst=x[1], estr=x[2], eeid=x[3],
                        SZf=size1, CSf=csum1, fin=x[4], merged=merged1,
                        it=0, flags=x[7])
    return ref, got


def test_colour_sums_bit_equal():
    """CSf after round 1 and after one compact round (the reference's
    round compiled, as inside its loop)."""
    img, cfg = CASES["20x24"]
    ref, got = _round1(img, cfg)
    for f in ("esrc", "edst", "estr", "eeid", "SZf", "CSf", "fin"):
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(got, f).numpy()), f
    v = img.shape[0] * img.shape[1]
    cap = max(v // 2, 16384)
    ref = jax.jit(rsp._sp_round, static_argnums=(1, 2))(ref, v, cap)
    got = tsp._sp_round(got, v, cap)
    for f in ("esrc", "edst", "SZf", "CSf", "fin"):
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(got, f).numpy()), f
    assert bool(ref.merged) == got.merged


def test_colour_distance_bit_equal_to_compiled_round():
    """XLA:CPU compiles the round's estr * sqrt(sum(da * da)) with fused
    multiply-adds; the port's arithmetic equals it bit for bit, and plain
    float32 arithmetic does not."""
    rng = np.random.default_rng(3)
    n = 50_000
    da = rng.uniform(-255, 255, (n, 3)).astype(np.float32)
    da[: n // 10] = rng.uniform(-1e-3, 1e-3, (n // 10, 3))
    estr = rng.uniform(0, 300, n).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda s, d: s * jnp.sqrt(jnp.sum(d * d, axis=-1)))(estr, da))
    got = torch.from_numpy(estr) * tsp._colour_distance(torch.from_numpy(da))
    assert np.array_equal(want, got.numpy())
    sq = da * da
    plain = estr * np.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2])
    assert not np.array_equal(want, plain)


@pytest.mark.parametrize("seed", [0, 1])
def test_ordered_scatter_add_equals_xla_scatter(seed):
    rng = np.random.default_rng(seed)
    v, n = 200, 5000
    base = rng.uniform(0, 255, (v, 3)).astype(np.float32)
    idx = rng.integers(-3, v + 40, n).astype(np.int32)   # some dropped
    idx[: n // 2] = rng.integers(0, 5, n // 2)            # long runs
    vals = rng.uniform(0, 1e4, (n, 3)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda b, i, x: b.at[jnp.where(i >= 0, i, v)].add(x, mode="drop"))(
            base, idx, vals))
    got = ks.ordered_scatter_add(*map(torch.from_numpy, (base, idx, vals)))
    assert np.array_equal(want, got.numpy())
    with pytest.raises(ValueError, match="ordered_scatter_add"):
        ks.ordered_scatter_add(torch.from_numpy(base).double(),
                               torch.from_numpy(idx), torch.from_numpy(vals))


@pytest.mark.parametrize("name", list(CASES))
def test_numpy_spec_equal(name):
    img, cfg = CASES[name]
    want = rnp.superpixel_hierarchy_np(img, _ref(cfg))
    got = tnp.superpixel_hierarchy_np(img, cfg)
    assert want[0].shape == got[0].shape
    for a, b in zip(want[0], got[0]):
        assert np.array_equal(canonical_min_labels_np(a),
                              canonical_min_labels_np(b))
    assert np.array_equal(want[1], got[1])


@pytest.mark.parametrize("hierarchy", [False, True])
def test_checked_entries_overflow_routes(hierarchy, monkeypatch):
    """A flagged run raises under "raise" and returns its labels under
    "ignore" and "fallback" (the path has no fallback route), as the
    reference's does."""
    img, cfg = CASES["20x24"]
    x = torch.from_numpy(img)
    entry, flagged = (("segment_superpixel_hierarchy",
                       "segment_superpixel_hierarchy_flagged") if hierarchy
                      else ("segment_superpixel", "segment_superpixel_flagged"))
    for mod in (tsp, rsp):
        fn = getattr(mod, flagged)
        monkeypatch.setattr(mod, flagged, lambda *a, fn=fn: (
            *fn(*a)[:-1], turbo.FLAG_COMP_OVERFLOW))
    for mode in ("raise", "ignore", "fallback"):
        c = dataclasses.replace(cfg, on_overflow=mode)
        if mode == "raise":
            for run in (lambda: getattr(tsp, entry)(x, c),
                        lambda: getattr(rsp, entry)(jnp.asarray(img),
                                                    _ref(c))):
                with pytest.raises(RuntimeError, match="component-head"):
                    run()
            continue
        want = getattr(rsp, entry)(jnp.asarray(img), _ref(c))
        got = getattr(tsp, entry)(x, c)
        want, got = (want, got) if hierarchy else ((want,), (got,))
        for w, g in zip(want, got, strict=True):
            assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("hierarchy", [False, True])
def test_segment_dispatch_byte_equal(hierarchy):
    img, cfg = CASES["20x24"]
    entries = ((gseg_tpu.segment_hierarchy, gseg_tpu_torch.segment_hierarchy)
               if hierarchy else (gseg_tpu.segment, gseg_tpu_torch.segment))
    want = entries[0](img, config=_ref(cfg))
    got = entries[1](img, config=cfg, device="cpu")
    want, got = (want, got) if hierarchy else ((want,), (got,))
    for w, g in zip(want, got, strict=True):
        assert g.device.type == "cpu"
        assert np.array_equal(np.asarray(w), g.numpy())

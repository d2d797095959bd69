"""The port's fastmst (DPP) path against `gseg_tpu`, on the CPU, with images
made from a numpy seed.

Labels are hook-sink root vertex ids, compared byte for byte (not
canonically), with flags, against the reference's jitted
`segment_fastmst_flagged` at its own test cases (tests/test_fastmst.py),
and against the port's `segment_atomic` and NumPy `segment_boruvka_np`.
At the reference's multi-chunk shape (260x300: more than one 131072-slot
chunk, a cross-chunk duplicate pair, the V/16 run-out slice) both run-out
routes are held to the reference, and the sliced one is shown to run.
The hierarchy (n_levels + 2 planes, levels past convergence repeating the
last, also with fewer levels than rounds) is byte-equal to the reference's.
`_chunked_pair_extract` is held to the reference's (mask, arrays,
overflow) with small chunks and pair caps, so that duplicates across
chunks and overflow both occur; `_s2_round` in both label conventions.
The checked entries' `on_overflow` routes (flags monkeypatched) and the
public dispatch route as the reference's do.
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
from gseg_tpu.models import atomic_boruvka as ra  # noqa: E402
from gseg_tpu.models import fastmst as rfm  # noqa: E402
from gseg_tpu.models import turbo as rt  # noqa: E402
import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import atomic_boruvka as ta  # noqa: E402
from gseg_tpu_torch.models import fastmst as tfm  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.models.boruvka_cpu import segment_boruvka_np  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

INT32_MAX = turbo.INT32_MAX

# tests/test_fastmst.py's CASES
CASES = [
    dict(h=24, w=32, k=100.0, min_size=8, seed=0),
    dict(h=33, w=17, k=300.0, min_size=20, seed=1),
    dict(h=16, w=16, k=50.0, min_size=1, seed=2),
]


def _ref(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


def _case(case):
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"],
                             algorithm="fastmst")
    return blobs_image(case["h"], case["w"], 5, 6.0, case["seed"]), cfg


@pytest.mark.parametrize("case", CASES)
def test_fastmst_byte_equal_to_reference(case):
    img, cfg = _case(case)
    want, wflags = rfm.segment_fastmst_flagged(jnp.asarray(img), _ref(cfg))
    got, flags = tfm.segment_fastmst_flagged(torch.from_numpy(img), cfg)
    assert got.dtype == torch.int32 and flags == int(wflags) == 0
    assert np.array_equal(np.asarray(want), got.numpy())
    assert np.array_equal(ta.segment_atomic(torch.from_numpy(img),
                                            cfg).numpy(), got.numpy())
    assert np.array_equal(segment_boruvka_np(img, cfg), got.numpy())


@functools.lru_cache(maxsize=None)
def _multichunk():
    img = blobs_image(260, 300, num_blobs=8, noise=8.0, seed=5)
    cfg = SegmentationConfig(k=150.0, min_size=20)
    want, flags = rfm.segment_fastmst_flagged(jnp.asarray(img), _ref(cfg))
    assert int(flags) == 0
    return img, cfg, np.asarray(want)


@pytest.mark.parametrize("small", [True, False])
def test_multichunk_runout_routes(small, monkeypatch):
    img, cfg, want = _multichunk()
    assert 4 * img.shape[0] * img.shape[1] > 131072  # several chunks
    pools = []
    runout = tfm._runout
    monkeypatch.setattr(turbo, "_S2_SMALL", small)
    monkeypatch.setattr(tfm, "_runout", lambda st, *a, **k: (
        pools.append(st.esrc.numel()), runout(st, *a, **k))[1])
    got, flags = tfm.segment_fastmst_flagged(torch.from_numpy(img), cfg)
    v = img.shape[0] * img.shape[1]
    # the pool recompacted to max(V/4, 16384), sliced to max(V/16, 16384)
    assert pools == [16384 if small else v // 4]
    assert flags == 0 and np.array_equal(want, got.numpy())
    assert np.array_equal(segment_boruvka_np(img, cfg), got.numpy())


@pytest.mark.parametrize("case,n_levels", [
    (CASES[0], None), (CASES[1], None), (CASES[0], 2)])
def test_hierarchy_byte_equal(case, n_levels):
    img, cfg = _case(case)
    r_levels, r_labels, r_flags = rfm.segment_fastmst_hierarchy_flagged(
        jnp.asarray(img), _ref(cfg), n_levels)
    levels, labels, flags = tfm.segment_fastmst_hierarchy_flagged(
        torch.from_numpy(img), cfg, n_levels)
    n = cfg.max_iters if n_levels is None else n_levels
    assert levels.shape == (n + 2, case["h"], case["w"])
    assert np.array_equal(np.asarray(r_levels), levels.numpy())
    assert np.array_equal(np.asarray(r_labels), labels.numpy())
    assert flags == int(r_flags) == 0
    flat = levels.numpy().reshape(n + 2, -1)
    assert np.array_equal(flat[0], np.arange(flat.shape[1]))
    for fine, coarse in zip(flat[:-1], flat[1:]):
        pairs = np.unique(np.stack([fine, coarse], 1), axis=0)
        assert np.unique(pairs[:, 0]).size == pairs.shape[0]
    if n_levels is None:  # converged long before max_iters: repeats
        assert np.array_equal(flat[-1], flat[-2])


def _pair_slots(n, chunk, kind, rng):
    """lo, hi, w, eid slots for the chunked dedup. kind: "random" (70%
    live, pairs over 30 labels), "empty_chunk" (the middle chunk of three
    dead: no heads between two chunks that have some), "all_dead" (every
    slot dead), or any other (random, as "random")."""
    live = rng.random(n) < 0.7
    if kind == "empty_chunk":
        live[chunk:2 * chunk] = False
    if kind == "all_dead":
        live[:] = False
    a, b = rng.integers(0, 30, n), rng.integers(0, 30, n)
    lo = np.where(live, np.minimum(a, b), INT32_MAX).astype(np.int32)
    hi = np.where(live, np.maximum(a, b), INT32_MAX).astype(np.int32)
    w = rng.choice(np.array([0.5, 1.0, 2.0, np.inf], np.float32), n)
    eid = rng.permutation(n).astype(np.int32)
    return lo, hi, w, eid


def _chunk_pairs(lo, hi, chunk):
    """The heads the dedup keeps: distinct live pairs counted per chunk."""
    return sum(len({(a, b) for a, b in zip(lo[i:i + chunk], hi[i:i + chunk])
                    if a != INT32_MAX})
               for i in range(0, len(lo), chunk))


# (n, chunk, cap, kind); cap None: exactly the heads kept (total == cap)
PAIR_CASES = [
    pytest.param(1000, 64, 200, "random", id="1000-64-200"),
    pytest.param(1000, 64, 40, "random", id="1000-64-40"),     # overflow
    pytest.param(999, 128, 900, "random", id="999-128-900"),
    pytest.param(5000, 256, 3000, "random", id="5000-256-3000"),
    pytest.param(3 * 64 - 5, 64, 200, "empty_chunk", id="empty_chunk"),
    pytest.param(1000, 64, 200, "all_dead", id="all_dead"),
    pytest.param(1000, 64, None, "exact_cap", id="total_eq_cap"),
    pytest.param(1000, 64, 1, "cap_one", id="pair_cap_1"),      # overflow
    pytest.param(8 * 128, 128, 900, "multiple", id="n_multiple_of_chunk"),
]


@pytest.mark.parametrize("n,chunk,cap,kind", PAIR_CASES)
def test_chunked_pair_extract_equal(n, chunk, cap, kind):
    rng = np.random.default_rng(n + chunk + (cap or 0))
    lo, hi, w, eid = _pair_slots(n, chunk, kind, rng)
    total = _chunk_pairs(lo, hi, chunk)
    if cap is None:
        cap = total
    want = jax.jit(rt._chunked_pair_extract, static_argnums=(4, 5))(
        *map(jnp.asarray, (lo, hi, w, eid)), cap, chunk)
    got = turbo._chunked_pair_extract(*map(torch.from_numpy,
                                           (lo, hi, w, eid)),
                                      cap, chunk=chunk)
    for x, y in zip(want, got):
        x = np.asarray(x)
        assert x.dtype == y.numpy().dtype and np.array_equal(x, y.numpy())
    assert bool(want[5]) == (total > cap)
    assert int(np.asarray(want[0]).sum()) == min(total, cap)
    if kind == "empty_chunk":   # the dead middle chunk keeps nothing
        assert 0 < _chunk_pairs(lo[:chunk], hi[:chunk], chunk) < total
    if kind != "random" or bool(want[5]):  # overflow: the output is invalid
        return
    # pairs repeat across chunks: more pairs kept than distinct ones
    m = np.asarray(want[0])
    kept = np.stack([np.asarray(want[1])[m], np.asarray(want[2])[m]], 1)
    assert len(kept) > len(np.unique(kept, axis=0))


def _compact_state(rng, v, e, ref):
    """A random stage-2 state: e directed edges over components 0..v-1
    (both orientations), sizes and Int at every slot."""
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    w = rng.choice(np.linspace(0.5, 40.0, 12).astype(np.float32), e)
    w[rng.random(e) < 0.1] = np.inf
    arrays = dict(esrc=np.concatenate([src, dst]),
                  edst=np.concatenate([dst, src]),
                  ew=np.concatenate([w, w]),
                  eeid=np.tile(rng.permutation(e).astype(np.int32), 2),
                  SZf=rng.integers(1, 40, v).astype(np.int32),
                  IDf=rng.uniform(0, 10, v).astype(np.float32),
                  fin=rng.integers(0, v, v // 2).astype(np.int32))
    if ref:
        return rt.CompactState(
            **{k: jnp.asarray(x) for k, x in arrays.items()},
            merged=jnp.bool_(True), it=jnp.int32(0), bucket=jnp.int32(0),
            phase=jnp.int32(0), flags=jnp.int32(0))
    return turbo.CompactState(
        **{k: torch.from_numpy(x) for k, x in arrays.items()},
        merged=True, it=0, bucket=0, phase=0,
        flags=torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("is_felz", [True, False])
def test_s2_round_equal(canonical, is_felz):
    v, e, cap = 300, 700, 256
    want = rt._s2_round(_compact_state(np.random.default_rng(7), v, e, True),
                        v, cap, 150.0, 20, jnp.bool_(is_felz),
                        canonical=canonical)
    got = turbo._s2_round(_compact_state(np.random.default_rng(7), v, e,
                                         False),
                          v, cap, 150.0, 20, is_felz, canonical=canonical)
    for name in ("esrc", "edst", "SZf", "IDf", "fin"):
        assert np.array_equal(np.asarray(getattr(want, name)),
                              getattr(got, name).numpy()), name
    assert got.merged == bool(want.merged)
    assert int(got.flags) == int(want.flags)


def _flagged(monkeypatch, mod, name, flags):
    fn = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a, **k: (*fn(*a, **k)[:-1], flags))


@pytest.mark.parametrize("hierarchy", [False, True])
def test_checked_entries_overflow_routes(hierarchy, monkeypatch):
    """A flagged run raises, returns anyway under "ignore", and falls back
    to the atomic path (its hierarchy) under "fallback", byte-equal to the
    reference's fallback."""
    img, cfg = _case(CASES[0])
    x = torch.from_numpy(img)
    entry, flagged = (("segment_fastmst_hierarchy",
                       "segment_fastmst_hierarchy_flagged") if hierarchy
                      else ("segment_fastmst", "segment_fastmst_flagged"))
    raw = getattr(tfm, flagged)(x, cfg)
    _flagged(monkeypatch, tfm, flagged, turbo.FLAG_PAIR_OVERFLOW)
    _flagged(monkeypatch, rfm, flagged, rt.FLAG_PAIR_OVERFLOW)
    with pytest.raises(RuntimeError, match="pair-extraction"):
        getattr(tfm, entry)(x, cfg)
    got = getattr(tfm, entry)(x, dataclasses.replace(cfg,
                                                     on_overflow="ignore"))
    got = got if hierarchy else (got,)
    assert all(torch.equal(a, b) for a, b in zip(got, raw[:-1]))
    fb = dataclasses.replace(cfg, on_overflow="fallback")
    want = getattr(rfm, entry)(jnp.asarray(img), _ref(fb))
    got = getattr(tfm, entry)(x, fb)
    want, got = ((want, got) if hierarchy else ((want,), (got,)))
    atomic = (ta.segment_atomic_hierarchy(x, fb) if hierarchy
              else (ta.segment_atomic(x, fb),))
    for w, g, a in zip(want, got, atomic):
        assert np.array_equal(np.asarray(w), g.numpy())
        assert torch.equal(g, a)


def test_segment_dispatch_byte_equal():
    img, cfg = _case(CASES[1])
    want = gseg_tpu.segment(img, config=_ref(cfg))
    got = gseg_tpu_torch.segment(img, config=cfg, device="cpu")
    assert np.array_equal(np.asarray(want), got.numpy())
    assert np.array_equal(np.asarray(ra.segment_atomic(jnp.asarray(img),
                                                       _ref(cfg))),
                          got.numpy())

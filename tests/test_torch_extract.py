"""PyTorch port's boundary extraction vs the JAX reference's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the reference
runs `gseg_tpu.ops.pallas.extract.boundary_extract` in Mosaic's TPU
interpret mode. Output order is free in both (the consumer sorts), so the
live entries are compared as multisets, exactly. The port's count is exact;
the reference's is an upper bound rounded to 128-lane rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import gseg_tpu.ops.grid_graph as jgg  # noqa: E402
from gseg_tpu.ops.pallas.extract import boundary_extract as jextract  # noqa: E402
from gseg_tpu_torch.ops.kernels import extract as kx  # noqa: E402

INT32_MAX = np.iinfo(np.int32).max


def _planes(rng, h, w, ncomp):
    L = rng.integers(0, ncomp, (h, w)).astype(np.int32)
    weights = rng.uniform(0.5, 9.0, (4, h, w)).astype(np.float32)
    for d, (dy, dx) in enumerate(jgg.DIRS4):
        weights[d][~np.asarray(jgg.valid_plane(h, w, dy, dx))] = np.inf
    return L, weights


def _live(lo, hi, wv, eid):
    lo, hi, wv, eid = (np.asarray(x) for x in (lo, hi, wv, eid))
    m = lo != INT32_MAX
    return sorted(zip(lo[m].tolist(), hi[m].tolist(), wv[m].tolist(),
                      eid[m].tolist()))


@pytest.fixture(autouse=True)
def _no_kernel_launches_on_cpu():
    yield
    assert kx.boundary_extract.launches == 0


# the shapes of tests/test_pallas_extract.py, multi-strip case included.
@pytest.mark.parametrize("shape,ncomp", [((13, 70), 5), ((24, 150), 9),
                                         ((8, 128), 3), ((150, 140), 11)])
def test_boundary_extract_matches_pallas(shape, ncomp):
    h, w = shape
    L, weights = _planes(np.random.default_rng(h * 31 + w), h, w, ncomp)
    cap = 1 << 14 if h * w <= 4096 else 1 << 17
    with pltpu.force_tpu_interpret_mode():
        ref = jextract(jnp.asarray(L), jnp.asarray(weights), w, cap)
    got = kx.boundary_extract(torch.from_numpy(L), torch.from_numpy(weights),
                              cap)
    assert not bool(ref[5]) and not bool(got[5])
    ref_live, got_live = _live(*ref[:4]), _live(*got[:4])
    assert got_live == ref_live
    n = int(got[4])
    assert n == len(got_live) <= int(ref[4])
    # live entries fill [0, count); the rest carry the sentinels
    lo, hi, wv, eid = (x.numpy() for x in got[:4])
    assert (lo[:n] != INT32_MAX).all()
    assert (lo[n:] == INT32_MAX).all() and (hi[n:] == INT32_MAX).all()
    assert (eid[n:] == INT32_MAX).all() and np.isinf(wv[n:]).all()


def test_boundary_extract_overflow_flag():
    """Checkerboard labels (every edge live, no runs) at cap 256 overflow:
    the flag is raised and the count stays exact."""
    h, w = 16, 128
    rng = np.random.default_rng(0)
    L = ((np.indices((h, w)).sum(axis=0) % 2) * (h * w)
         + np.arange(h * w).reshape(h, w)).astype(np.int32)
    _, weights = _planes(rng, h, w, 1)
    with pltpu.force_tpu_interpret_mode():
        *_, ref_ovf = jextract(jnp.asarray(L), jnp.asarray(weights), w, 256)
    lo, _, _, _, count, ovf = kx.boundary_extract(
        torch.from_numpy(L), torch.from_numpy(weights), 256)
    assert bool(ref_ovf) and bool(ovf)
    n_valid = int(np.isfinite(weights).sum())
    assert int(count) == n_valid > 256
    assert (lo.numpy() != INT32_MAX).all()


def test_boundary_extract_rejects_mismatched_weights():
    L = torch.zeros((4, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        kx.boundary_extract(L, torch.zeros((4, 5, 4)), 128)
    with pytest.raises(ValueError):
        kx.boundary_extract(L.to("meta"), torch.zeros((4, 4, 5),
                                                      device="meta"), 128)

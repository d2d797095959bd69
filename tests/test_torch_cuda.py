"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one; run them on the
card with `python -m pytest --noconftest tests/test_torch_cuda.py -q`
(`--noconftest`: tests/conftest.py imports jax, which that machine lacks).
They import no jax: the references are the port's own plain PyTorch
versions (held against the JAX package by the other tests/test_torch_*.py
files) and its CPU run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops import filters  # noqa: E402
from gseg_tpu_torch.ops import grid_graph as gg  # noqa: E402
from gseg_tpu_torch.ops.kernels import extract as kx  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

pytestmark = pytest.mark.cuda

# below, at and across the 32x32 tile of csrc/gossip.cu; 1-row and 1-column
# images included.
SHAPES = [(1, 37), (37, 1), (5, 3), (23, 70), (32, 32), (33, 65), (96, 56)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


def _fields(h, w, dev, seed, ncomp):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(x).to(dev)

    return dict(
        L=t(rng.integers(0, ncomp, (h, w)).astype(np.int32)),
        bw=t(rng.uniform(0, 1, (h, w)).astype(np.float32)),
        be=t(rng.integers(0, 10_000, (h, w)).astype(np.int32)),
        sz=t(rng.integers(1, 9, (h, w)).astype(np.int32)),
        allow=t(rng.integers(0, 256, (h, w)).astype(np.int32)),
    )


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ncomp", [1, 3, 50])
def test_fixpoint_kernels_equal_plain(dev, shape, ncomp):
    h, w = shape
    f = _fields(h, w, dev, seed=h * 100 + w + ncomp, ncomp=ncomp)
    ms = 4 * (h + w)
    n0 = (kg.compmin_gossip.launches, kg.label_flood.launches,
          kg.value_flood.launches)
    got = kg.compmin_gossip(f["L"], f["bw"], f["be"], f["sz"], ms)
    ref = kg.compmin_gossip_plain(f["L"], f["bw"], f["be"], f["sz"], ms)
    assert _equal(got[:3], ref[:3]) and got[3] is ref[3] is False
    got = kg.label_flood(f["allow"], f["be"], f["bw"], ms)
    ref = kg.label_flood_plain(f["allow"], f["be"], f["bw"], ms)
    assert _equal(got[:2], ref[:2]) and got[2] is ref[2] is False
    got = kg.value_flood(f["L"], f["be"], ms)
    ref = kg.value_flood_plain(f["L"], f["be"], ms)
    assert torch.equal(got[0], ref[0]) and got[1] is ref[1] is False
    n1 = (kg.compmin_gossip.launches, kg.label_flood.launches,
          kg.value_flood.launches)
    assert all(b > a for a, b in zip(n0, n1))


def test_fixpoint_kernel_pass_cap_flags_unconverged(dev):
    """A chain longer than the pass cap allows ends unconverged."""
    w = 200
    L = torch.zeros((1, w), dtype=torch.int32, device=dev)
    val = torch.arange(w, dtype=torch.int32, device=dev).flip(0)[None]
    _, unconv = kg.value_flood(L, val, 16)
    assert unconv is True
    got, unconv = kg.value_flood(L, val, 4 * (1 + w))
    assert unconv is False and int(got.max()) == 0


def _pool(res):
    lo, hi, wv, eid, count, ovf = res
    n = int(count)
    keys = torch.stack([x[:n].double() for x in (lo, hi, wv, eid)], 1)
    keys = keys.cpu().numpy()
    return keys[np.lexsort(keys.T[::-1])], bool(ovf), n


@pytest.mark.parametrize("shape", SHAPES)
def test_extract_kernel_equals_plain(dev, shape):
    h, w = shape
    rng = np.random.default_rng(h * 7 + w)
    L = torch.from_numpy(rng.integers(0, 3, (h, w)).astype(np.int32)).to(dev)
    weights = rng.choice(np.float32([0.5, 1.0, 2.0, 3.5]), (4, h, w))
    for d, (dy, dx) in enumerate(gg.DIRS4):
        weights[d][~gg.valid_plane(h, w, dy, dx).numpy()] = np.inf
    weights = torch.from_numpy(weights).to(dev)
    n0 = kx.boundary_extract.launches
    for cap in (4 * h * w, 7):
        got = _pool(kx.boundary_extract(L, weights, cap))
        ref = _pool(kx.boundary_extract_plain(L, weights, cap))
        assert got[1:] == ref[1:]
        if not got[1]:
            assert np.array_equal(got[0], ref[0])
    assert kx.boundary_extract.launches == n0 + 2


def test_wrappers_refuse_mixed_devices(dev):
    L = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kg.value_flood(L, torch.zeros((4, 4), dtype=torch.int32), 32)
    with pytest.raises(ValueError):
        kx.boundary_extract(L, torch.zeros((4, 4, 4)), 64)


@pytest.mark.parametrize("case", [
    dict(h=24, w=32, k=100.0, min_size=8, connectivity=8, seed=0),
    dict(h=16, w=16, k=50.0, min_size=1, connectivity=4, seed=2),
    dict(h=1, w=37, k=100.0, min_size=5, connectivity=8, seed=3),
    dict(h=96, w=56, k=200.0, min_size=20, connectivity=8, seed=11),
])
def test_turbo_on_card_equals_cpu(dev, case):
    """The whole path on the card gives the CPU run's labels and flags,
    both fed the same weight planes."""
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"],
                             connectivity=case["connectivity"])
    img = torch.from_numpy(blobs_image(case["h"], case["w"], 6, 6.0,
                                       case["seed"]))
    cpu_labels, cpu_flags = turbo.segment_turbo_impl(img, cfg, 2)
    weights = gg.edge_weight_planes(filters.gaussian_smooth(img, cfg.sigma),
                                    cfg.connectivity)[0]
    labels, flags = turbo.segment_turbo_impl(img.to(dev), cfg, 2,
                                             weights_override=weights)
    assert labels.device.type == "cuda"
    assert flags == cpu_flags == 0
    assert torch.equal(labels.cpu(), cpu_labels)

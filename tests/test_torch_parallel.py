"""The port's batching and multi-device layer (`gseg_tpu_torch.parallel`)
against `gseg_tpu.parallel` on the 8-device virtual CPU mesh of
tests/conftest.py, and its rank group.

Inputs are built from seeds with numpy; labels and flags must be byte-
equal (tolerance 0). The port's meshes are lists of CPU devices here
(`["cpu"] * n`: one thread per rank); the turbo path's row-sharded form is
in tests/test_torch_turbo_spatial.py.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
from gseg_tpu.parallel import batching as ref_batching  # noqa: E402
from gseg_tpu.parallel import spatial as ref_spatial  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops.kernels import _build  # noqa: E402
from gseg_tpu_torch.parallel import batching, mesh, spatial  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

needs_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices")
ALGOS = ("atomic", "turbo", "fastmst", "superpixel")


def _cfg(**kw):
    return SegmentationConfig(**({"k": 120.0, "min_size": 4, "max_iters": 16}
                                 | kw))


def _ref(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


def _images(n, h=16, w=24):
    return np.stack([blobs_image(h, w, 4, 5.0, s) for s in range(n)])


def _np(blocks):
    return torch.cat([b.cpu() for b in blocks]).numpy()


@pytest.fixture(scope="module")
def ref_batches():
    """The reference's segment_batch_flagged per algorithm (2 x 16x24)."""
    imgs = jnp.asarray(_images(2))
    out = {}
    for algo in ALGOS:
        labels, flags = ref_batching.segment_batch_flagged(
            imgs, _ref(_cfg(algorithm=algo)))
        out[algo] = (np.asarray(labels), int(flags))
    return out


@pytest.mark.parametrize("algo", ALGOS)
def test_segment_batch_matches_reference(ref_batches, algo):
    imgs = torch.from_numpy(_images(2))
    cfg = _cfg(algorithm=algo)
    labels, flags = batching.segment_batch_flagged(imgs, cfg, "cpu")
    want, want_flags = ref_batches[algo]
    assert flags == want_flags == 0
    assert labels.dtype == torch.int32
    assert np.array_equal(labels.numpy(), want)
    assert np.array_equal(
        batching.segment_batch(imgs, cfg, "cpu").numpy(), want)


def test_segment_batch_overflow_fallback_and_raise(monkeypatch):
    """Capacities forced small on low-k noise: the flags match the
    reference's, "raise" raises in both packages, "fallback" re-runs the
    batch on the atomic path (byte-equal to the reference's), "ignore"
    keeps the flagged labels."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2, 24, 32, 3)).astype(np.float32)
    cfg = SegmentationConfig(k=1e-3, min_size=1, sigma=0.0, max_iters=7,
                             algorithm="turbo")
    monkeypatch.setattr(turbo, "_CAP_FLOOR", 64)
    monkeypatch.setattr(ref_turbo, "_CAP_FLOOR", 64)
    timgs, jimgs = torch.from_numpy(imgs), jnp.asarray(imgs)
    _, flags = batching.segment_batch_flagged(timgs, cfg, "cpu")
    _, ref_flags = ref_batching.segment_batch_flagged(jimgs, _ref(cfg))
    assert flags == int(ref_flags) and flags & turbo.FLAG_PAIR_OVERFLOW
    with pytest.raises(RuntimeError, match="capacity"):
        batching.segment_batch(timgs, cfg, "cpu")
    with pytest.raises(RuntimeError, match="capacity"):
        ref_batching.segment_batch(jimgs, _ref(cfg))
    fb = dataclasses.replace(cfg, on_overflow="fallback")
    got = batching.segment_batch(timgs, fb, "cpu")
    want = ref_batching.segment_batch(jimgs, _ref(fb))
    assert np.array_equal(got.numpy(), np.asarray(want))
    ignored = batching.segment_batch(
        timgs, dataclasses.replace(cfg, on_overflow="ignore"), "cpu")
    assert ignored.shape == (2, 24, 32)
    with pytest.raises(RuntimeError, match="capacity"):
        batching.segment_batch_sharded(
            timgs, cfg, batching.data_parallel_mesh(["cpu"] * 2))
    fallback = batching.segment_batch_sharded(
        timgs, fb, batching.data_parallel_mesh(["cpu"] * 2))
    assert np.array_equal(_np(fallback), np.asarray(want))


@needs_devices
def test_segment_batch_sharded_matches_reference():
    imgs = _images(8)
    cfg = _cfg(algorithm="atomic")
    want = ref_batching.segment_batch_sharded(
        jnp.asarray(imgs), _ref(cfg),
        ref_batching.data_parallel_mesh(jax.devices()[:8]))
    blocks = batching.segment_batch_sharded(
        torch.from_numpy(imgs), cfg, batching.data_parallel_mesh(["cpu"] * 8))
    assert len(blocks) == 8 and all(b.shape == (1, 16, 24) for b in blocks)
    assert np.array_equal(_np(blocks), np.asarray(want))


def test_segment_batch_sharded_turbo_equals_batch():
    imgs = torch.from_numpy(_images(4))
    cfg = _cfg(algorithm="turbo")
    blocks = batching.segment_batch_sharded(
        imgs, cfg, batching.data_parallel_mesh(["cpu"] * 2))
    assert [b.shape[0] for b in blocks] == [2, 2]
    assert torch.equal(torch.cat(blocks),
                       batching.segment_batch(imgs, cfg, "cpu"))


@pytest.mark.parametrize("fn", ["segment_batch", "segment_batch_flagged"])
def test_segment_batch_defaults_to_the_card(monkeypatch, fn):
    """A NumPy batch goes to cuda:0 unless a device is asked for: without
    a card that raises, as gseg_tpu_torch.segment does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(batching, fn)(_images(2), _cfg(algorithm="atomic"))


@needs_devices
def test_segment_spatial_matches_reference():
    img = blobs_image(32, 24, 4, 5.0, 0)
    cfg = _cfg(algorithm="atomic")
    want = ref_spatial.segment_spatial(
        jnp.asarray(img), _ref(cfg), ref_spatial.spatial_mesh(
            jax.devices()[:4]))
    got = spatial.segment_spatial(img, cfg, spatial.spatial_mesh(["cpu"] * 4))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@needs_devices
def test_multichip_step_matches_reference():
    imgs = _images(4)
    cfg = _cfg(algorithm="atomic")
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                  ("data", "space"))
    want = ref_spatial.multichip_step(jnp.asarray(imgs), _ref(cfg), jmesh)
    m = mesh.Mesh(["cpu"] * 8, ("data", "space"), (2, 4))
    blocks = spatial.multichip_step(torch.from_numpy(imgs), cfg, m)
    assert [tuple(b.shape) for b in blocks] == [(2, 16, 24)] * 2
    assert np.array_equal(_np(blocks), np.asarray(want))


def test_mesh_shape_and_groups():
    m = mesh.Mesh(["cpu"] * 6, ("data", "space"), (2, 3))
    assert m.shape == {"data": 2, "space": 3}
    assert [len(g) for g in m.groups("space")] == [3, 3]
    assert [len(g) for g in m.groups("data")] == [2, 2, 2]
    with pytest.raises(ValueError):
        mesh.Mesh(["cpu"] * 6, ("data", "space"), (4, 2))
    with pytest.raises(ValueError, match="besides"):
        spatial.segment_spatial(blobs_image(12, 8, 2, 5.0, 0), _cfg(), m)


def test_cuda_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: spatial.spatial_mesh(),
                 lambda: spatial.spatial_mesh(["cuda:0"] * 2),
                 lambda: batching.data_parallel_mesh(),
                 lambda: mesh.run_ranks(["cuda:0"], lambda r, t: 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_halo_spans_ranks_and_fills():
    """halo(x, k) of tiles shorter than k equals the rows of the padded
    global plane, with a fill and with the edge row repeated."""
    rng = np.random.default_rng(0)
    plane = torch.from_numpy(rng.integers(0, 99, (15, 4)).astype(np.int32))
    k, n = 7, 5
    tiles = list(plane.split(3))
    for fill in (-1, None):
        top = plane[:1].expand(k, 4) if fill is None else torch.full(
            (k, 4), fill, dtype=torch.int32)
        bot = plane[-1:].expand(k, 4) if fill is None else torch.full(
            (k, 4), fill, dtype=torch.int32)
        padded = torch.cat([top, plane, bot])
        got = mesh.run_ranks(["cpu"] * n,
                             lambda r, t, f=fill: r.halo(t, k, f), tiles)
        for i, g in enumerate(got):
            assert torch.equal(g, padded[3 * i:3 * i + 3 + 2 * k])


def test_collectives():
    def fn(rank, x):
        return (rank.any(rank.index == 2), rank.sum(rank.index),
                rank.or_flags(1 << rank.index), rank.all_gather_rows(x),
                rank.all_reduce_min(torch.tensor([rank.index, -rank.index])))

    tiles = [torch.full((2, 3), i) for i in range(4)]
    for got in mesh.run_ranks(["cpu"] * 4, fn, tiles):
        assert got[:3] == (True, 6, 15)
        assert torch.equal(got[3], torch.cat(tiles))
        assert torch.equal(got[4], torch.tensor([0, -3]))


def test_failing_rank_raises_without_hanging():
    """A rank that raises breaks the barrier: the call re-raises its error
    (not the others' broken waits) at once."""
    def fn(rank, _):
        if rank.index == 2:
            raise ValueError("rank 2 failed")
        rank.any(True)
        rank.any(True)

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 2 failed"):
        mesh.run_ranks(["cpu"] * 4, fn)
    assert time.perf_counter() - t0 < 5


@pytest.mark.parametrize("case", ["different collective", "returns early",
                                  "never arrives"])
def test_mismatched_or_late_ranks_raise(case):
    def fn(rank, _):
        if rank.index == 1:
            if case == "different collective":
                return rank.sum(1)
            if case == "returns early":
                return None
            time.sleep(3)
        return rank.any(False)

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="different collectives|broken"):
        mesh.run_ranks(["cpu"] * 3, fn, timeout=0.5)
    assert time.perf_counter() - t0 < 10


def test_launch_counter_keeps_every_count_under_threads():
    """16 threads bump one counter with a tiny switch interval: no count is
    lost (a bare += would lose some)."""
    class W:
        launches = 0

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count(W) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert W.launches == 16 * 2000

"""PyTorch port (gseg_tpu_torch) vs the JAX reference: filters (Gaussian
smoothing, Sobel magnitude), edge-weight planes, incident views, synthetic
images, label helpers and the config.

All comparisons are exact: the port's float32 filter chain is bit-equal to
the reference's on the CPU."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gseg_tpu import config as jconfig  # noqa: E402
from gseg_tpu.ops import filters as jfilters  # noqa: E402
from gseg_tpu.ops import grid_graph as jgg  # noqa: E402
from gseg_tpu.utils import labels as jlabels  # noqa: E402
from gseg_tpu.utils import synthetic as jsyn  # noqa: E402
from gseg_tpu_torch import config as tconfig  # noqa: E402
from gseg_tpu_torch.ops import filters as tfilters  # noqa: E402
from gseg_tpu_torch.ops import grid_graph as tgg  # noqa: E402
from gseg_tpu_torch.utils import labels as tlabels  # noqa: E402
from gseg_tpu_torch.utils import synthetic as tsyn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("shape", [(37, 53), (1, 29), (64, 80)])
@pytest.mark.parametrize("sigma", [0.0, 0.5, 0.8, 1.7])
def test_gaussian_smooth_bit_equal(shape, sigma):
    img = _image(*shape, seed=shape[0] + shape[1])
    ref = np.asarray(jfilters.gaussian_smooth(jnp.asarray(img), sigma))
    got = tfilters.gaussian_smooth(torch.from_numpy(img), sigma).numpy()
    assert np.array_equal(ref, got)
    assert np.array_equal(jfilters.gaussian_kernel_1d(sigma),
                          tfilters.gaussian_kernel_1d(sigma))


@pytest.mark.parametrize("connectivity,qbits", [(8, 0), (4, 0), (8, 12),
                                                (8, 8)])
def test_edge_weight_planes_and_incident_views_bit_equal(connectivity, qbits):
    img = _image(41, 67, seed=3)
    smoothed = np.asarray(jfilters.gaussian_smooth(jnp.asarray(img), 0.8))
    rw, rv = jgg.edge_weight_planes(jnp.asarray(smoothed), connectivity,
                                    qbits)
    gw, gv = tgg.edge_weight_planes(torch.from_numpy(smoothed.copy()),
                                    connectivity, qbits)
    assert np.array_equal(np.asarray(rw), gw.numpy())
    assert np.array_equal(np.asarray(rv), gv.numpy())
    rw8, re8 = jgg.incident_views(rw)
    gw8, ge8 = tgg.incident_views(gw)
    assert np.array_equal(np.asarray(rw8), gw8.numpy())
    assert np.array_equal(np.asarray(re8), ge8.numpy())


@pytest.mark.parametrize("shape", [(37, 53, 3), (1, 29, 3), (12, 14, 2),
                                   (16, 9)])
@pytest.mark.parametrize("smooth", [False, True])
def test_sobel_magnitude_bit_equal(shape, smooth):
    """Luma (or the channel mean), both separable Sobel passes and the root
    equal the reference's op by op, on raw and on smoothed images."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(
        np.uint8)
    if smooth:
        img = np.array(jfilters.gaussian_smooth(jnp.asarray(img), 0.8))
    ref = np.asarray(jfilters.sobel_magnitude(jnp.asarray(img)))
    got = tfilters.sobel_magnitude(torch.from_numpy(img))
    assert got.dtype == torch.float32 and np.array_equal(ref, got.numpy())


@pytest.mark.parametrize("dy,dx", list(jgg.DIRS8))
def test_shift_and_valid_planes_equal(dy, dx):
    x = np.arange(7 * 9, dtype=np.int32).reshape(7, 9)
    assert np.array_equal(np.asarray(jgg.shift_plane(jnp.asarray(x), dy, dx,
                                                     -1)),
                          tgg.shift_plane(torch.from_numpy(x), dy, dx,
                                          -1).numpy())
    assert np.array_equal(np.asarray(jgg.valid_plane(7, 9, dy, dx)),
                          tgg.valid_plane(7, 9, dy, dx).numpy())


@pytest.mark.parametrize("make", [
    lambda m: m.blobs_image(24, 32, 5, 6.0, 0),
    lambda m: m.blobs_image(33, 17, 7, 8.0, 9),
    # past 2^22 pixels both packages switch to the float32 GEMM branch
    lambda m: m.blobs_image(2049, 2048, 12, 8.0, 1),
    lambda m: m.textured_image(40, 56, 2),
    lambda m: m.gradient_image(20, 30),
    lambda m: m.checkerboard_image(24, 40, 6),
])
def test_synthetic_images_byte_equal(make):
    ref, got = make(jsyn), make(tsyn)
    assert ref.dtype == got.dtype and np.array_equal(ref, got)


def test_label_helpers_equal():
    lab = np.random.default_rng(4).integers(0, 9, (13, 21)).astype(np.int32)
    assert np.array_equal(jlabels.compact_labels_np(lab),
                          tlabels.compact_labels_np(lab))
    assert np.array_equal(jlabels.canonical_min_labels_np(lab),
                          tlabels.canonical_min_labels_np(lab))
    assert jlabels.num_components(lab) == tlabels.num_components(lab)


def test_config_round_trips():
    ref = jconfig.SegmentationConfig(sigma=0.5, k=120.0, min_size=7,
                                     max_iters=12, algorithm="turbo",
                                     quantize_weight_bits=12,
                                     connectivity=4, on_overflow="ignore")
    port = tconfig.SegmentationConfig(**dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert tconfig.ALGORITHMS == jconfig.ALGORITHMS
    for bad in (dict(algorithm="nope"), dict(connectivity=6),
                dict(quantize_weight_bits=3), dict(on_overflow="drop")):
        with pytest.raises(ValueError):
            jconfig.SegmentationConfig(**bad)
        with pytest.raises(ValueError):
            tconfig.SegmentationConfig(**bad)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import gseg_tpu_torch, gseg_tpu_torch.models.turbo\n"
        "import gseg_tpu_torch.models.fastmst\n"
        "import gseg_tpu_torch.models.superpixel\n"
        "import gseg_tpu_torch.models.fastmst_np\n"
        "import gseg_tpu_torch.ops.kernels.gossip\n"
        "import gseg_tpu_torch.ops.kernels.extract\n"
        "import gseg_tpu_torch.utils.synthetic, gseg_tpu_torch.utils.labels\n"
        "import gseg_tpu_torch.utils.image_io, gseg_tpu_torch.utils.datasets\n"
        "import gseg_tpu_torch.metrics.compare\n"
        "import gseg_tpu_torch.native.bindings\n"
        "import gseg_tpu_torch.cli, gseg_tpu_torch.__main__\n"
        "import gseg_tpu_torch.bench.harness, gseg_tpu_torch.bench.__main__\n"
        "import gseg_tpu_torch.bench.plots, gseg_tpu_torch.bench.fig3\n"
        "import gseg_tpu_torch.bench.profile_turbo\n"
        "import gseg_tpu_torch.bench.flagship\n"
        "import gseg_tpu_torch.utils.timing\n"
        "import gseg_tpu_torch.parallel.mesh\n"
        "import gseg_tpu_torch.parallel.batching\n"
        "import gseg_tpu_torch.parallel.spatial\n"
        "import gseg_tpu_torch.parallel.turbo_spatial\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gseg_tpu' or m.startswith('gseg_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

"""The plain PyTorch DPP reference (`models/fastmst_plain.py`) against the
port's fastmst and atomic paths, on the CPU, with frames made from a seed.
No jax.

- `segment(algorithm=..., device="cpu")` with algorithm fastmst and atomic
  returns root-id labels byte-equal to the plain reference's on
  uniform-noise and blob frames at 24x32, 48x64 and 96x128, k 10 and 300,
  min_size 1 and 20. The noise takes values 0..63: on full-range noise at
  k 10 the first round merges almost nothing, and the fastmst path's pair
  and recompaction capacities (as the JAX package's) overflow and raise,
  which is pinned here too; the atomic path, which has no capacity, gives
  the plain reference's labels on that frame.
- The plain reference's partition equals the NumPy oracle's
  (`boruvka_cpu.segment_boruvka_np`).
- The control: the plain reference in bfloat16 (smoothed frame and
  weights rounded) gives another partition than the port's on some case,
  so the comparison would catch the lower precision.
- The plain reference and its frozen copy in the benchmark import
  nothing but math, numpy and torch.
- The plain reference leaves the process's TF32 settings as it found
  them.
On the card (marker `cuda`; `python -m pytest --noconftest
tests/test_torch_fastmst_plain.py`): the same comparison for both paths at
270x480, and at 3840x2160 on frames of the `blobs-4k` mix (126 blobs,
noise 8).
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import fastmst_plain  # noqa: E402
from gseg_tpu_torch.models.boruvka_cpu import segment_boruvka_np  # noqa: E402
from gseg_tpu_torch.utils.labels import canonical_min_labels_np  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SIZES = [(24, 32), (48, 64), (96, 128)]
CONTENTS = ["noise", "blobs"]


def _frame(content, h, w, seed, high=64):
    if content == "noise":
        return np.random.default_rng(seed).integers(0, high, (h, w, 3),
                                                    dtype=np.uint8)
    return blobs_image(h, w, max(3, h * w // 1536), 8.0, seed)


def _cfg(k, min_size, algorithm="fastmst"):
    return SegmentationConfig(algorithm=algorithm, k=k, min_size=min_size)


def _plain(img, cfg, **kw):
    return fastmst_plain.segment(img, sigma=cfg.sigma, k=cfg.k,
                                 min_size=cfg.min_size,
                                 max_iters=cfg.max_iters,
                                 connectivity=cfg.connectivity, **kw)


@pytest.mark.parametrize("min_size", [1, 20])
@pytest.mark.parametrize("k", [10.0, 300.0])
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("algorithm", ["fastmst", "atomic"])
def test_fastmst_byte_equal_to_plain(algorithm, content, h, w, k, min_size):
    img = _frame(content, h, w, seed=h * 1000 + int(k) + min_size)
    cfg = _cfg(k, min_size, algorithm)
    got = gseg_tpu_torch.segment(img, config=cfg, device="cpu")
    want = _plain(img, cfg)
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape == (h, w)
    assert got.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("content,h,w,k,min_size", [
    ("noise", 48, 64, 10.0, 20), ("blobs", 96, 128, 300.0, 20),
    ("blobs", 33, 17, 100.0, 8)])
def test_plain_partition_equals_boruvka_np(content, h, w, k, min_size):
    img = _frame(content, h, w, seed=7 + h)
    cfg = _cfg(k, min_size)
    want = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    got = fastmst_plain.canonical_labels(_plain(img, cfg)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(canonical_min_labels_np(_plain(img, cfg).numpy()),
                          want)


def test_full_range_noise_overflows_the_path_not_the_plain_reference():
    img = _frame("noise", 48, 64, seed=3, high=256)
    cfg = _cfg(10.0, 1)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        gseg_tpu_torch.segment(img, config=cfg, device="cpu")
    labels = _plain(img, cfg)
    assert labels.shape == (48, 64)
    assert canonical_min_labels_np(labels.numpy()).tolist() == \
        canonical_min_labels_np(segment_boruvka_np(img, cfg)).tolist()


def test_full_range_noise_atomic_byte_equal_to_plain():
    """The frame that overflows the fastmst path: the atomic path, which
    has no capacity, gives the plain reference's labels byte for byte."""
    img = _frame("noise", 48, 64, seed=3, high=256)
    cfg = _cfg(10.0, 1, "atomic")
    got = gseg_tpu_torch.segment(img, config=cfg, device="cpu")
    assert got.numpy().tobytes() == _plain(img, cfg).numpy().tobytes()


def test_bfloat16_plain_reference_disagrees_with_the_port():
    """The control: fed bf16-rounded weights, the plain reference gives
    another partition than the port on at least one case."""
    off = []
    for content in CONTENTS:
        for h, w in SIZES:
            img = _frame(content, h, w, seed=h * 1000 + 310)
            cfg = _cfg(300.0 if content == "blobs" else 10.0, 1)
            port = gseg_tpu_torch.segment(img, config=cfg, device="cpu")
            low = _plain(img, cfg, precision="bfloat16")
            off.append(int(np.count_nonzero(
                canonical_min_labels_np(port.numpy())
                != canonical_min_labels_np(low.numpy()))))
    assert max(off) > 0, off


def test_bfloat16_rounding_is_to_nearest_even():
    x = torch.tensor([1.0, 1.00390625, 1.005859375, float("inf")])
    got = fastmst_plain.to_bfloat16(x)
    assert got.tolist() == [1.0, 1.0, 1.0078125, float("inf")]
    with pytest.raises(ValueError, match="precision"):
        fastmst_plain.segment(np.zeros((4, 4, 3), np.uint8),
                              precision="float16")


@pytest.mark.parametrize("path", ["gseg_tpu_torch/models/fastmst_plain.py",
                                  "segbench/reference_dpp.py"])
def test_plain_reference_imports_nothing_of_the_port(path):
    tree = ast.parse((REPO / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: a relative import"
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch"}, names


@pytest.mark.parametrize("matmul,cudnn", [(True, True), (False, True)])
def test_plain_reference_restores_tf32_settings(monkeypatch, matmul, cudnn):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", matmul)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn)
    _plain(_frame("blobs", 24, 32, 1), _cfg(300.0, 20))
    assert torch.backends.cuda.matmul.allow_tf32 is matmul
    assert torch.backends.cudnn.allow_tf32 is cudnn


# (h, w, blobs, seed, also against the NumPy oracle)
CARD_FRAMES = {"270x480": (270, 480, 12, 11, True),
               "4k-a": (2160, 3840, 126, 2905512331, False),
               "4k-b": (2160, 3840, 126, 3808000031, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("frame", CARD_FRAMES)
@pytest.mark.parametrize("algorithm", ["fastmst", "atomic"])
def test_fastmst_byte_equal_to_plain_on_card(algorithm, frame):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, w, blobs, seed, oracle = CARD_FRAMES[frame]
    img = blobs_image(h, w, blobs, 8.0, seed)
    cfg = SegmentationConfig(algorithm=algorithm, k=300.0, min_size=100)
    got = gseg_tpu_torch.segment(img, config=cfg, device="cuda:0")
    want = _plain(torch.from_numpy(img).cuda(), cfg)
    assert want.is_cuda and torch.equal(got, want)
    if oracle:
        assert np.array_equal(
            canonical_min_labels_np(want.cpu().numpy()),
            canonical_min_labels_np(segment_boruvka_np(img, cfg)))

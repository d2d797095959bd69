"""The port's ASA/UE metrics (`gseg_tpu_torch.metrics.compare`) against
`gseg_tpu.metrics.compare`, on the CPU.

- `asa_ue` and `asa_ue_best_gt`: exactly the reference's floats on seeded
  label maps (segmentations of blobs images and random maps), and on a
  tie of ASA between two ground truths with different UE, where the
  first one is kept (strict >).
- `asa_ue_torch`: exactly NumPy's `asa_ue` (both divide integer sums by
  the pixel count in float64), and the reference's float32 `asa_ue_jax`
  within 1e-6, also when codes fall outside the table and are dropped.
The card's run of `asa_ue_torch` is in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gseg_tpu.metrics import compare as ref  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.metrics import compare  # noqa: E402
from gseg_tpu_torch.models.felzenszwalb_cpu import (  # noqa: E402
    segment_kruskal_np)
from gseg_tpu_torch.utils.labels import compact_labels_np  # noqa: E402
from gseg_tpu_torch.utils.synthetic import (  # noqa: E402
    blobs_ground_truth, blobs_image, bsds_like_scene)

JAX_TOL = 1e-6  # the reference's asa_ue_jax sums and divides in float32


def _case(kind, seed):
    """(seg, [gts]) of one seeded case."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        seg = rng.integers(0, 40, (31, 47)).astype(np.int32) * 7 + 3
        gts = [rng.integers(0, n, (31, 47)).astype(np.int32)
               for n in (2, 5, 9)]
        return seg, gts
    if kind == "blobs":
        img = blobs_image(40, 56, 6, 12.0, seed)
        gts = [blobs_ground_truth(40, 56, 6, seed)]
    else:
        img, gts = bsds_like_scene(48, 72, n_regions=20, seed=seed)
    seg = segment_kruskal_np(img, SegmentationConfig(k=80.0, min_size=10))
    return seg, gts


CASES = [("random", 0), ("random", 1), ("blobs", 2), ("bsds_like", 3),
         ("bsds_like", 4)]


@pytest.mark.parametrize("kind,seed", CASES)
def test_asa_ue_exact(kind, seed):
    seg, gts = _case(kind, seed)
    for gt in gts:
        assert compare.asa_ue(seg, gt) == ref.asa_ue(seg, gt)
    got = compare.asa_ue_best_gt(compact_labels_np(seg), gts)
    assert got == ref.asa_ue_best_gt(compact_labels_np(seg), gts)
    assert 0.0 < got[0] <= 1.0 and got[1] >= 0.0


def test_best_gt_keeps_the_first_of_a_tie():
    # ASA 0.5 against both; UE 0.75 against gt1, 1.0 against gt2
    seg = np.array([0] * 6 + [1] * 2)
    gt1 = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    gt2 = np.array([0, 0, 0, 1, 1, 1, 2, 3])
    assert compare.asa_ue(seg, gt1) == (0.5, 0.75)
    assert compare.asa_ue(seg, gt2) == (0.5, 1.0)
    for gts in ([gt1, gt2], [gt2, gt1]):
        got = compare.asa_ue_best_gt(seg, gts)
        assert got == ref.asa_ue_best_gt(seg, gts) == compare.asa_ue(
            seg, gts[0])


@pytest.mark.parametrize("kind,seed", CASES)
def test_asa_ue_torch_equals_numpy_and_jax(kind, seed):
    seg, gts = _case(kind, seed)
    seg = compact_labels_np(seg)
    for gt in gts:
        gt = compact_labels_np(gt)
        ns, ng = int(seg.max()) + 1, int(gt.max()) + 1
        asa, ue = compare.asa_ue_torch(torch.from_numpy(seg),
                                       torch.from_numpy(gt), ns, ng)
        assert asa.dtype == ue.dtype == torch.float64 and asa.dim() == 0
        assert (float(asa), float(ue)) == compare.asa_ue(seg, gt)
        ja, ju = ref.asa_ue_jax(jnp.asarray(seg), jnp.asarray(gt), ns, ng)
        assert abs(float(asa) - float(ja)) <= JAX_TOL
        assert abs(float(ue) - float(ju)) <= JAX_TOL


def test_asa_ue_torch_drops_codes_outside_the_table():
    seg, gts = _case("random", 5)
    seg, gt = compact_labels_np(seg), compact_labels_np(gts[1])
    ns, ng = int(seg.max()) + 1, int(gt.max()) + 1
    for num_seg in (ns - 3, 1):  # the top segment ids fall outside
        asa, ue = compare.asa_ue_torch(torch.from_numpy(seg),
                                       torch.from_numpy(gt), num_seg, ng)
        ja, ju = ref.asa_ue_jax(jnp.asarray(seg), jnp.asarray(gt), num_seg,
                                ng)
        assert abs(float(asa) - float(ja)) <= JAX_TOL
        assert abs(float(ue) - float(ju)) <= JAX_TOL
        assert float(asa) < compare.asa_ue(seg, gt)[0]

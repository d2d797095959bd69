"""The port's NumPy Boruvka oracle and the oracle partition it committed.

- `gseg_tpu_torch.models.boruvka_cpu.segment_boruvka_np` gives labels
  byte-equal to `gseg_tpu.models.boruvka_cpu.segment_boruvka_np` on small
  blob, textured and thin images, in speed and quality mode.
- The committed 4K quality-mode oracle
  (`gseg_tpu_torch/oracles/blobs_2160x3840_wb16.npz`) loads as canonical
  (2160, 3840) int32 labels with 90 components. Remaking it takes about a
  minute (`python -m gseg_tpu_torch.oracles`), so it is only read here.
"""

import numpy as np
import pytest

from gseg_tpu.config import SegmentationConfig as JConfig
from gseg_tpu.models import boruvka_cpu as jb
from gseg_tpu.utils.synthetic import blobs_image, textured_image
from gseg_tpu_torch.config import SegmentationConfig
from gseg_tpu_torch.models import boruvka_cpu as tb
from gseg_tpu_torch.oracles import ORACLES, load_oracle, oracle_path


@pytest.mark.parametrize("case", [
    dict(img=("blobs", 60, 80), k=150.0, min_size=20, wb=0),
    dict(img=("blobs", 60, 80), k=150.0, min_size=20, wb=16),
    dict(img=("textured", 48, 64), k=20.0, min_size=5, wb=16),
    dict(img=("blobs", 3, 40), k=100.0, min_size=5, wb=0),
], ids=["blobs-wb0", "blobs-wb16", "textured-wb16", "thin-3x40"])
def test_boruvka_copy_is_byte_equal_to_the_reference(case):
    kind, h, w = case["img"]
    img = (blobs_image(h, w, 6, 6.0, 1) if kind == "blobs"
           else textured_image(h, w, 2))
    kw = dict(k=case["k"], min_size=case["min_size"],
              weight_buckets=case["wb"])
    want = jb.segment_boruvka_np(img, JConfig(**kw))
    got = tb.segment_boruvka_np(img, SegmentationConfig(**kw))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert 1 < np.unique(got).size < h * w


def test_committed_4k_quality_oracle_is_canonical():
    assert ORACLES["blobs_2160x3840_wb16"] == (2160, 3840, 16)
    labels = load_oracle(oracle_path("blobs_2160x3840_wb16"))
    assert labels.shape == (2160, 3840) and labels.dtype == np.int32
    flat = labels.ravel()
    # each label is a member of its own class and no larger than any
    # member: the class's min flat index
    assert (flat <= np.arange(flat.size)).all()
    assert (flat[flat] == flat).all()
    assert np.unique(flat).size == 90


def test_load_oracle_reads_the_reference_npy_oracles():
    """One loader for both formats: the reference's bare `.npy` arrays
    load as they are."""
    path = "bench_out/oracle_bench_1080x1920_wb16.npy"
    labels = load_oracle(path)
    assert labels.shape == (1080, 1920)
    assert np.array_equal(labels, np.load(path))

"""The port's NumPy Boruvka oracle and the oracle partition it committed.

- `gseg_tpu_torch.models.boruvka_cpu.segment_boruvka_np` gives labels
  byte-equal to `gseg_tpu.models.boruvka_cpu.segment_boruvka_np` on small
  blob, textured and thin images, in speed and quality mode.
- The copies of `fastmst_np` (one round, the pipeline and its per-round
  levels) and `felzenszwalb_cpu` give results byte-equal to the
  reference's at small sizes (at full size a run takes minutes; the
  1080p levels are held by the committed level oracle on the card).
- The committed level oracle of the 1080p hierarchy lists 33 levels, from
  the identity to the final felz partition, its counts non-increasing.
- The committed 4K quality-mode oracle
  (`gseg_tpu_torch/oracles/blobs_2160x3840_wb16.npz`) loads as canonical
  (2160, 3840) int32 labels with 90 components. Remaking it takes about a
  minute (`python -m gseg_tpu_torch.oracles`), so it is only read here.
"""

import hashlib

import numpy as np
import pytest

from gseg_tpu.config import SegmentationConfig as JConfig
from gseg_tpu.models import boruvka_cpu as jb
from gseg_tpu.models import fastmst_np as jf
from gseg_tpu.models import felzenszwalb_cpu as jk
from gseg_tpu.utils.synthetic import blobs_image, textured_image
from gseg_tpu_torch.config import SegmentationConfig
from gseg_tpu_torch.models import boruvka_cpu as tb
from gseg_tpu_torch.models import fastmst_np as tf
from gseg_tpu_torch.models import felzenszwalb_cpu as tk
from gseg_tpu_torch.oracles import (
    LEVEL_ORACLES, ORACLES, load_level_oracle, load_oracle, oracle_path)

NP_CASES = [
    dict(img=("blobs", 24, 32, 0), k=100.0, min_size=8),
    dict(img=("blobs", 20, 28, 3), k=120.0, min_size=1, max_iters=12),
    dict(img=("textured", 24, 20, 2), k=20.0, min_size=5),
    dict(img=("blobs", 1, 37, 3), k=100.0, min_size=5),
]


def _np_case(case):
    kind, h, w, seed = case["img"]
    img = (blobs_image(h, w, 5, 6.0, seed) if kind == "blobs"
           else textured_image(h, w, seed))
    kw = {k: v for k, v in case.items() if k != "img"}
    return img, JConfig(**kw), SegmentationConfig(**kw)


@pytest.mark.parametrize("case", NP_CASES, ids=lambda c: "x".join(
    str(x) for x in c["img"]))
def test_fastmst_np_copy_is_byte_equal(case):
    img, jcfg, cfg = _np_case(case)
    want_levels = jf.segment_fastmst_np(img, jcfg, return_levels=True)
    got_levels = tf.segment_fastmst_np(img, cfg, return_levels=True)
    for want, got in zip(want_levels, got_levels, strict=True):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tf.segment_fastmst_np(img, cfg),
                          jf.segment_fastmst_np(img, jcfg))


def test_fastmst_round_np_copy_is_byte_equal():
    img, jcfg, cfg = _np_case(NP_CASES[0])
    sm = tb.gaussian_smooth_np(img, cfg.sigma)
    weights, _ = tb.edge_weight_planes_np(sm)
    ea, eb, ew, ev = tb._edge_arrays(weights, np.isfinite(weights),
                                     img.shape[1])
    live = np.nonzero(ev)[0]
    edges = (ea[live], eb[live], ew[live], live.astype(np.int64))
    v = img.shape[0] * img.shape[1]
    state = (np.arange(v, dtype=np.int64), np.ones(v, np.int64),
             np.zeros(v, np.float32))
    for mode in ("felz", "felz", "minsize"):
        want = jf.fastmst_round_np(*state, *edges, cfg.k, cfg.min_size, mode)
        got = tf.fastmst_round_np(*state, *edges, cfg.k, cfg.min_size, mode)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        state = got[:3]


@pytest.mark.parametrize("case", NP_CASES, ids=lambda c: "x".join(
    str(x) for x in c["img"]))
def test_felzenszwalb_copy_is_byte_equal(case):
    img, jcfg, cfg = _np_case(case)
    want = jk.segment_kruskal_np(img, jcfg)
    got = tk.segment_kruskal_np(img, cfg)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_committed_level_oracle_is_consistent():
    name = "levels_blobs_1080x1920_wb0"
    spec, data = LEVEL_ORACLES[name], load_level_oracle(name)
    counts = [lv["components"] for lv in data["levels"]]
    assert len(counts) == spec["config"]["max_iters"] + 1
    assert counts[0] == spec["image"][0] * spec["image"][1]
    assert all(a >= b for a, b in zip(counts, counts[1:]))
    final = load_oracle(spec["oracle"])
    assert data["final"]["components"] == np.unique(final).size
    assert data["final"]["sha256"] == hashlib.sha256(
        final.astype(np.int32).tobytes()).hexdigest()
    # level 0 is the identity map
    assert data["levels"][0]["sha256"] == hashlib.sha256(
        np.arange(counts[0], dtype=np.int32).tobytes()).hexdigest()


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

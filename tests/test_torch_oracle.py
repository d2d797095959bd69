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
- The committed oracles of the resolution ladder's 540p, 720p and 1440p
  rungs load as canonical int32 labels of their rung's shape, with the
  sha256 of their label bytes that `tests/check_oracle_4k.py` found equal
  to the reference's NumPy Boruvka.
- Every committed oracle (the 5K and 8K rungs and the textured ones too)
  loads as canonical int32 labels of its shape with the component count
  and label sha256 of `oracles.RECORDED`; `make_oracle`'s recipe (blobs
  and textured content, the bench's k and min_size or an entry's own)
  gives the reference's `segment_boruvka_np` + `canonical_min_labels_np`
  on the reference's own images at small shapes (at 5K and 8K a remake
  takes minutes, so none runs here).
- At the 5K and 8K rungs, in speed and quality mode, the turbo and
  fastmst capacities (`turbo.capacities`, `fastmst.capacities`: the root
  list and its slices, the candidate and pair pools, the compact root
  list) and the chunks of the chunked pair extraction (`turbo.pair_chunks`)
  equal the reference's formulas at its default gates, computed from the
  shapes alone.
"""

import hashlib
import inspect

import numpy as np
import pytest

from gseg_tpu.config import SegmentationConfig as JConfig
from gseg_tpu.models import boruvka_cpu as jb
from gseg_tpu.models import fastmst_np as jf
from gseg_tpu.models import felzenszwalb_cpu as jk
from gseg_tpu.models import turbo as jturbo
from gseg_tpu.utils.labels import canonical_min_labels_np as jcanonical
from gseg_tpu.utils.synthetic import blobs_image, textured_image
from gseg_tpu_torch import oracles
from gseg_tpu_torch.config import SegmentationConfig
from gseg_tpu_torch.models import boruvka_cpu as tb
from gseg_tpu_torch.models import fastmst as tfastmst
from gseg_tpu_torch.models import fastmst_np as tf
from gseg_tpu_torch.models import felzenszwalb_cpu as tk
from gseg_tpu_torch.models import turbo as tturbo
from gseg_tpu_torch.oracles import (
    LEVEL_ORACLES, ORACLES, RECORDED, load_level_oracle, load_oracle,
    make_oracle, oracle_path)

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


# name -> sha256 of the label bytes (`python -m gseg_tpu_torch.oracles`
# prints it; `tests/check_oracle_4k.py <name>` holds the labels against
# gseg_tpu's segment_boruvka_np)
LADDER_ORACLES = {
    "blobs_540x960_wb0":
        "b77557b1952915b1233dd29591a4f1e6ac43857937df55f93ebcfbfa0c1f0827",
    "blobs_720x1280_wb0":
        "b4eeb24b8ec2ddc0970abfad252bc0446aba15324d8a7ac8dcd6df26cd296c7a",
    "blobs_1440x2560_wb0":
        "35b814ba7c68b9d4d5be2e743d6c6131c045491bc869d1c9bd0092616cfb86c1",
}


@pytest.mark.parametrize("name", sorted(LADDER_ORACLES))
def test_committed_ladder_oracles(name):
    h, w, wb = ORACLES[name]
    assert wb == 0 and name == f"blobs_{h}x{w}_wb0"
    labels = load_oracle(oracle_path(name))
    assert labels.shape == (h, w) and labels.dtype == np.int32
    assert hashlib.sha256(labels.tobytes()).hexdigest() == LADDER_ORACLES[
        name]
    flat = labels.ravel()
    assert (flat <= np.arange(flat.size)).all()
    assert (flat[flat] == flat).all()


def test_load_oracle_reads_the_reference_npy_oracles():
    """One loader for both formats: the reference's bare `.npy` arrays
    load as they are."""
    path = "bench_out/oracle_bench_1080x1920_wb16.npy"
    labels = load_oracle(path)
    assert labels.shape == (1080, 1920)
    assert np.array_equal(labels, np.load(path))


def test_every_oracle_has_a_record():
    assert set(RECORDED) == set(ORACLES)
    assert set(oracles.RECIPES) <= set(ORACLES)


@pytest.mark.parametrize("name", sorted(ORACLES))
def test_committed_oracles_match_their_record(name):
    h, w, _ = ORACLES[name]
    labels = load_oracle(oracle_path(name))
    assert labels.shape == (h, w) and labels.dtype == np.int32
    components, digest = RECORDED[name]
    assert hashlib.sha256(labels.tobytes()).hexdigest() == digest
    flat = labels.ravel()
    assert (flat <= np.arange(flat.size)).all()
    assert (flat[flat] == flat).all()
    assert np.unique(flat).size == components


# small stand-ins for the committed recipes: (h, w, wb), recipe, reference
# image
SMALL_RECIPES = {
    "textured_48x64_k10_wb16": ((48, 64, 16),
                                dict(content="textured", k=10.0,
                                     min_size=10),
                                lambda: textured_image(48, 64, seed=0)),
    "textured_60x80_wb0": ((60, 80, 0), dict(content="textured"),
                           lambda: textured_image(60, 80, seed=0)),
    "blobs_60x80_wb0": ((60, 80, 0), None,
                        lambda: blobs_image(60, 80, num_blobs=8, noise=8.0,
                                            seed=0)),
}


@pytest.mark.parametrize("name", sorted(SMALL_RECIPES))
def test_make_oracle_recipe_equals_the_reference(monkeypatch, name):
    shape, recipe, image = SMALL_RECIPES[name]
    monkeypatch.setitem(oracles.ORACLES, name, shape)
    if recipe is not None:
        monkeypatch.setitem(oracles.RECIPES, name, recipe)
    spec = dict(content="blobs", k=300.0, min_size=100) | (recipe or {})
    ref_cfg = JConfig(sigma=0.8, k=spec["k"], min_size=spec["min_size"],
                      max_iters=32, weight_buckets=shape[2])
    want = jcanonical(jb.segment_boruvka_np(image(), ref_cfg))
    got = make_oracle(name)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _reference_capacities(v, wb):
    """The reference's capacity formulas at its default gates:
    gseg_tpu/models/turbo.py:1118 and :1177 (the root list after the peel
    rounds), :1141-1143 and :1199 (its slices), :1278-1279 (pair pool),
    :1297-1300 (candidate pool), :1385-1387 and :1432-1436 (compact root
    list, stage 2's past 2^20 pixels)."""
    gd, gdq = jturbo._gate_div(), jturbo._gate_div_q()
    floor, rfloor = jturbo._CAP_FLOOR, jturbo._RLIST_FLOOR
    if wb > 0:
        return {"rcap": v, "rlist_caps": [max(v // 16, rfloor)],
                "cap_live": max(v // 2, 1 << 16),
                "pair_cap": max(v // min(6, max(gdq // 5, 2)), floor),
                "comp_cap": max(v // min(24, max(gdq * 3 // 4, 2)), floor)}
    return {"rcap": max(v // 4, floor), "rlist_caps": [max(v // 32, rfloor)],
            "cap_live": max(v if gd < 64 else v // 2, 1 << 16),
            "pair_cap": max(v // min(24, max(gd // 4, 3)), floor),
            "comp_cap": max(v // min(96, max(gd * 3 // 4, 2)), floor)}


def _reference_chunks(n):
    """gseg_tpu/models/turbo.py:1220-1222, at its default chunk."""
    chunk = inspect.signature(jturbo._chunked_pair_extract).parameters[
        "chunk"].default
    nch = max(n // chunk, 1)
    npad = nch * chunk if n % chunk == 0 else (n // chunk + 1) * chunk
    return npad // chunk


@pytest.mark.parametrize("wb", [0, 16])
@pytest.mark.parametrize("shape", [(2880, 5120), (4320, 7680)])
def test_capacities_at_5k_and_8k_are_the_reference_formulas(monkeypatch,
                                                            shape, wb):
    for var in ("GSEG_GATE_DIV", "GSEG_GATE_DIV_Q", "GSEG_RLIST_TIERS_Q"):
        monkeypatch.delenv(var, raising=False)
    v = shape[0] * shape[1]
    assert tturbo.capacities(v, wb) == _reference_capacities(v, wb)
    # fastmst: gseg_tpu/models/fastmst.py:123-124, its pairs extracted
    # from the 4V edge slots in chunks
    assert tfastmst.capacities(v) == {
        "pair_cap": max(v + v // 4, 16384), "comp_cap": max(v // 2, 16384)}
    assert tturbo.pair_chunks(4 * v) == _reference_chunks(4 * v)
    assert tturbo.PAIR_CHUNK == inspect.signature(
        jturbo._chunked_pair_extract).parameters["chunk"].default
    # the 4V edge ids of the pair extraction stay int32
    assert 4 * v < 2**31

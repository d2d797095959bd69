"""Bench-scale multi-device parity (`gseg_tpu_torch.bench.spatial_parity`,
the port of `scripts/spatial_parity_540p.py`) on CPU ranks.

- A reduced plan (48x80 on 4 CPU ranks; blobs and textured; wb0 and wb16)
  gives every row equal with flags 0, and writes the JSON record with the
  reference's row keys; a row whose partitions differ exits 1.
- On one case (blobs 48x80, speed mode, 8 ranks) the port's row-sharded
  labels and flags are byte-equal to `gseg_tpu.parallel.turbo_spatial`'s
  on the 8-device virtual CPU mesh of tests/conftest.py.
- The plan and the configuration are the reference's; with --cards rank i
  takes card i modulo the card count.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.parallel import spatial as ref_spatial  # noqa: E402
from gseg_tpu.parallel import turbo_spatial as ref_ts  # noqa: E402
from gseg_tpu.utils.synthetic import (  # noqa: E402
    blobs_image as ref_blobs, textured_image as ref_textured)
from gseg_tpu_torch.bench import harness, spatial_parity  # noqa: E402
from gseg_tpu_torch.parallel.spatial import spatial_mesh  # noqa: E402
from gseg_tpu_torch.parallel.turbo_spatial import (  # noqa: E402
    segment_turbo_spatial)

# the keys of the rows of bench_out/spatial_parity.json
REF_KEYS = ["content", "h", "w", "n_dev", "weight_buckets", "equal",
            "dense_flags", "spatial_flags", "dense_s", "spatial_s"]


def test_reduced_plan_rows_equal_with_the_reference_keys(tmp_path, capsys):
    out = tmp_path / "sp.json"
    rc = spatial_parity.main(["--device", "cpu", "--shape", "48x80x4",
                              "--out", str(out)])
    assert rc == 0
    record = json.loads(out.read_text())
    assert record["ok"] is True and record["mesh"] == "ranks on cpu"
    rows = record["rows"]
    assert [(r["content"], r["weight_buckets"]) for r in rows] == [
        ("blobs", 0), ("blobs", 16), ("textured", 0), ("textured", 16)]
    for r in rows:
        assert list(r) == REF_KEYS
        assert (r["h"], r["w"], r["n_dev"]) == (48, 80, 4)
        assert r["equal"] and r["dense_flags"] == r["spatial_flags"] == 0
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x[len("RESULT "):]) for x in lines[:-1]] == rows
    assert lines[-1] == "OK"


def test_a_differing_row_exits_one(tmp_path, monkeypatch, capsys):
    def split(image, cfg, mesh, axis, rounds):
        labels, flags = segment_turbo_spatial(image, cfg, mesh, axis, rounds)
        labels = labels.clone()
        labels[0, 0] = labels.numel()  # one pixel split off
        return labels, flags

    monkeypatch.setattr(spatial_parity, "segment_turbo_spatial", split)
    monkeypatch.setattr(spatial_parity, "WEIGHT_BUCKETS", (0,))
    monkeypatch.setattr(spatial_parity, "CONTENTS", ("blobs",))
    out = tmp_path / "sp.json"
    rc = spatial_parity.main(["--device", "cpu", "--shape", "32x40x4",
                              "--out", str(out)])
    assert rc == 1
    record = json.loads(out.read_text())
    assert record["ok"] is False and not record["rows"][0]["equal"]
    assert capsys.readouterr().out.splitlines()[-1] == "MISMATCH"


def test_eight_ranks_byte_equal_to_the_reference():
    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    img = harness.ladder_image(48, 80, "blobs")
    cfg = spatial_parity.config(0)
    want, want_flags = ref_ts.segment_turbo_spatial(
        jnp.asarray(img), RefConfig(**dataclasses.asdict(cfg)),
        ref_spatial.spatial_mesh(jax.devices()[:8]), "space", 2)
    got, flags = segment_turbo_spatial(
        torch.from_numpy(img), cfg, spatial_mesh(["cpu"] * 8), "space", 2)
    assert flags == int(want_flags) == 0
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.unique(got.numpy()).size > 1


def test_plan_images_and_devices_are_the_reference_ones(monkeypatch):
    assert spatial_parity.PLAN == ((540, 960, 4), (720, 1280, 8))
    cfg = spatial_parity.config(16)
    assert (cfg.k, cfg.min_size, cfg.weight_buckets) == (300.0, 100, 16)
    # the reference's images, at a small size
    assert np.array_equal(harness.ladder_image(48, 80, "blobs"),
                          ref_blobs(48, 80, num_blobs=8, seed=0))
    assert np.array_equal(harness.ladder_image(48, 80, "textured"),
                          ref_textured(48, 80, seed=0))
    cpu = torch.device("cpu")
    assert spatial_parity.rank_devices(4, cpu, False) == [cpu] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert spatial_parity.rank_devices(8, cpu, True) == [
        torch.device("cuda", i % 4) for i in range(8)]

"""The 4K deployments' benchmark pieces on the CPU at a tiny size: the
harness takes `fastmst-speed` x `blobs-4k` (`fastmst-4k`) and
`turbo-quality` x `blobs-4k` (`quality-4k`); the frozen plain DPP
reference (`reference_dpp.py`) equals the program's (`fastmst_plain.py`)
and the canonical partition of the NumPy reference (`reference.py`); the
five DPP readers read a traced fastmst run (the span readers the
program's device-time counters, which on the CPU are the spans' own
times) and leave their metrics out when the program's tracing is off or
missing."""

import io
import json

import numpy as np
import pytest
import torch

from gseg_tpu_torch.models import fastmst_plain
from gseg_tpu_torch.utils import timing
from segbench import (frames, harness, program, reference, reference_dpp,
                      spec)
from segbench.trace import Trace

DPP = ("dpp_round1_ms", "dpp_extract_ms", "dpp_rounds_ms", "dpp_final_ms",
       "dpp_recompactions_per_frame")
SPANS = ("dpp_round1_ms", "dpp_extract_ms", "dpp_rounds_ms", "dpp_final_ms")


def run_line(root, workload, trace):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, 3_900_000_123, 0.5, trace, root=root,
                     device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


@pytest.mark.parametrize("workload,algorithm,buckets",
                         [("fastmst-4k", "fastmst", 0),
                          ("quality-4k", "turbo", 16)])
def test_check_cell_takes_the_new_cell(workload, algorithm, buckets):
    c = spec.cell(workload)
    harness.check_cell(c["config"], c["traffic"])
    assert (c["traffic"]["height"], c["traffic"]["width"]) == (2160, 3840)
    assert c["entry"]["chips"] == 1
    assert c["config"]["algorithm"] == algorithm
    assert c["config"]["weight_buckets"] == buckets


def test_fastmst_speed_is_turbo_speed_on_the_dpp_path():
    fast = spec.cell("fastmst-4k")["config"]
    turbo = spec.cell("speed-4k")["config"]
    assert fast["algorithm"] == "fastmst" and "gossip_rounds" not in fast
    same = set(reference.KEYS) | set(harness.FIXED) - {"hierarchy_levels"}
    assert {k: fast[k] for k in same} == {k: turbo[k] for k in same}
    assert fast["reduced"] == []
    names = [m["name"] for m in spec.cell("fastmst-4k")["per_layer"]]
    assert names == list(DPP)


@pytest.mark.parametrize("content,h,w,seed", [("blobs", 48, 64, 0),
                                              ("blobs", 61, 45, 2**40 + 9),
                                              ("bsds_like", 40, 56, 5)])
@pytest.mark.parametrize("k,min_size", [(300.0, 100), (20.0, 8)])
def test_frozen_dpp_reference_equals_the_plain_and_the_numpy(content, h, w,
                                                             seed, k,
                                                             min_size):
    t = {"content": content, "height": h, "width": w, "pool": 1}
    t |= ({"num_blobs": 5, "noise": 8.0} if content == "blobs"
          else {"n_regions": 6})
    img = frames.make_pool(t, seed)[0]
    kw = dict(sigma=0.8, k=k, min_size=min_size, max_iters=32,
              connectivity=8)
    frozen = reference_dpp.segment(img, **kw)
    assert frozen.dtype == torch.int32
    assert torch.equal(frozen, fastmst_plain.segment(img, **kw))
    want = reference.reference_partition(img, kw | {"weight_buckets": 0})
    assert np.array_equal(reference.canonical_labels(frozen.numpy()), want)
    assert np.array_equal(reference_dpp.canonical_labels(frozen).numpy(),
                          want)


def test_dpp_readers_read_a_traced_fastmst_run(tiny_root):
    line, _ = run_line(tiny_root, "fastmst-4k", True)
    assert line["correct"] is True
    got = line["metrics"]
    assert set(got) == set(DPP)
    for name in SPANS:
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms/frame"
    assert got["dpp_recompactions_per_frame"] == {"value": 2.0,
                                                  "unit": "count/frame"}
    gaps = [name for name, _ in line["breakdown"]["idle_gaps"]]
    assert any(g.startswith("gseg.") for g in gaps), gaps
    assert not timing.enabled()


def test_dpp_metrics_left_out_untraced_and_without_tracing(tiny_root,
                                                           monkeypatch):
    line, _ = run_line(tiny_root, "fastmst-4k", False)
    assert not set(DPP) & set(line["metrics"])
    monkeypatch.setattr(program, "_timing", lambda: None)
    line, err = run_line(tiny_root, "fastmst-4k", True)
    assert line["correct"] is True
    assert not set(DPP) & set(line["metrics"])
    for name in DPP:
        assert f"{name}: nothing to wrap" in err


@pytest.mark.parametrize("name", DPP)
def test_dpp_reader_reads_none_when_the_program_recorded_nothing(name):
    tr = Trace("cpu")
    tr.frames = 3
    assert spec.layer_reader(name).read(tr) is None

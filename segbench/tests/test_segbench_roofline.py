"""The step roofline's byte count, the peaks table and the reduction of a
trace (busy union, idle share, breakdown), on the CPU."""

import pytest
import torch

from segbench import roofline, spec
from segbench.trace import Trace, merge


def test_fixpoint_bytes_formula():
    # read-only plane + 3 fields read once, 3 written once, 4 bytes each
    assert roofline.fixpoint_bytes(1080, 1920, 3) == 4 * 1080 * 1920 * 7
    assert roofline.fixpoint_bytes(2, 3, 1) == 72


def test_peaks_by_card_name():
    assert roofline.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    with pytest.raises(KeyError):
        roofline.peak("cpu", "hbm_bytes_per_s")


def test_step_roofline_counts_every_fixpoint_call():
    """At 40 x 56 on the CPU: the reader's byte count equals the bytes of
    the calls that a second, independent wrapper sees."""
    import gseg_tpu_torch
    from gseg_tpu_torch.config import SegmentationConfig
    from gseg_tpu_torch.ops.kernels import gossip
    from segbench import synthetic

    seen = []
    inner = gossip._fixpoint

    def outer(variant, plain, ro, fields, *a, **kw):
        seen.append((tuple(ro.shape), len(fields)))
        return inner(variant, plain, ro, fields, *a, **kw)

    gossip._fixpoint = outer
    tr = Trace("cpu")
    reader = spec.layer_reader("step_roofline")
    try:
        assert reader.instrument(tr)
        img = torch.from_numpy(synthetic.blobs_image(40, 56, 5, 8.0, 3))
        cfg = SegmentationConfig(algorithm="turbo", weight_buckets=16)
        gseg_tpu_torch.segment(img, config=cfg, device="cpu")
    finally:
        tr.restore()
        gossip._fixpoint = inner
    assert seen and all(s == (40, 56) for s, _ in seen)
    assert tr.counters["fixpoint_calls"] == len(seen)
    assert tr.counters["fixpoint_bytes"] == sum(
        4 * 40 * 56 * (1 + 2 * n) for _, n in seen)
    # no device trace on the CPU: the reader finds nothing to read
    assert reader.read(tr) is None


def _synthetic_trace():
    tr = Trace("cpu")
    tr.window = (0, 1000)
    tr.device_ops = [("void fixpoint_pass<(Op)1, 8>(int const*)", 100, 300),
                     ("void fixpoint_pass<(Op)1, 8>(int const*)", 250, 400),
                     ("Memcpy DtoH", 900, 1100), ("late", 2000, 2100)]
    # host: the window, a frame, a stage span, an op inside it
    tr._host = [(0, 1000, "segbench.window", True, 1),
                (0, 950, "segbench.frame", True, 1),
                (400, 800, "turbo._s2_stage", True, 1),
                (420, 790, "aten::sort", False, 1),
                (430, 500, "cudaLaunchKernel", False, 1)]
    return tr


def test_busy_union_and_idle_share():
    tr = _synthetic_trace()
    assert merge([(5, 7), (1, 3), (2, 4)]) == [[1, 4], [5, 7]]
    # [100, 400] and [900, 1000] inside the window: 400 ns of 1000
    assert tr.busy_s == pytest.approx(400e-9)
    assert tr.window_s == pytest.approx(1000e-9)
    idle = spec.layer_reader("device_idle_share")
    tr.device = torch.device("cuda")  # the reader reads device traces only
    assert idle.read(tr) == pytest.approx(60.0)
    assert tr.device_seconds("fixpoint_pass") == pytest.approx(350e-9)


def test_device_work_a_frame():
    tr = _synthetic_trace()
    tr.device = torch.device("cuda")
    tr.frames = 2
    # 400 ns busy over 2 frames; 3 operations overlap the window
    ms = spec.layer_reader("device_ms_per_frame")
    assert ms.read(tr) == pytest.approx(400e-9 * 1e3 / 2)
    ops = spec.layer_reader("device_ops_per_frame")
    assert ops.read(tr) == pytest.approx(1.5)
    tr.device_ops = []
    assert ms.read(tr) is None and ops.read(tr) is None


def test_breakdown_names_what_the_host_did():
    tr = _synthetic_trace()
    b = tr.breakdown()
    ops = dict(b["device_ops"])
    assert ops["fixpoint_pass<(Op)1, 8>"] == pytest.approx(350e-9)
    gaps = dict(b["idle_gaps"])
    # gaps [0, 100] (frame), [400, 900] (midpoint 650: in the stage span,
    # inside aten::sort)
    assert gaps["segbench.frame / python"] == pytest.approx(100e-9)
    assert gaps["turbo._s2_stage / aten::sort"] == pytest.approx(500e-9)

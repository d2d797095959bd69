"""The readers of the program's own spans and counters
(`segbench/program.py`, `layers/extract_ms.py`, `final_map_ms.py`,
`host_wait_ms.py`, `fixpoint_passes_per_frame.py`) on the CPU at a tiny
size: a traced run carries all four, its idle gaps name the program's
spans, the program's tracing is off again after the run, and a program
without the tracing leaves the four out without failing."""

import io
import json

import pytest

from gseg_tpu_torch.utils import timing
from segbench import harness, program

NEW = ("extract_ms", "final_map_ms", "host_wait_ms",
       "fixpoint_passes_per_frame")


def run_line(root, workload, trace=True):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, 4000000017, 0.5, trace, root=root,
                     device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


@pytest.mark.parametrize("workload", ["speed-1080p", "quality-1080p"])
def test_traced_line_carries_the_program_metrics(tiny_root, workload):
    line, _ = run_line(tiny_root, workload)
    assert line["correct"] is True
    for name in NEW:
        assert line["metrics"][name]["value"] > 0, name
    assert line["metrics"]["fixpoint_passes_per_frame"]["unit"] == \
        "passes/frame"
    gaps = [name for name, _ in line["breakdown"]["idle_gaps"]]
    assert any(g.startswith("gseg.") for g in gaps), gaps
    assert not timing.enabled()


def test_untraced_run_leaves_the_tracing_off(tiny_root):
    line, _ = run_line(tiny_root, "speed-photos", trace=False)
    assert not set(NEW) & set(line["metrics"])
    assert not timing.enabled()
    assert timing.take() == timing.Record([], {})


def test_a_program_without_tracing_leaves_the_metrics_out(tiny_root,
                                                          monkeypatch):
    monkeypatch.setattr(program, "_timing", lambda: None)
    line, err = run_line(tiny_root, "speed-1080p")
    assert line["correct"] is True
    assert not set(NEW) & set(line["metrics"])
    assert "host_reads_per_frame" in line["metrics"]
    for name in NEW:
        assert f"{name}: nothing to wrap" in err

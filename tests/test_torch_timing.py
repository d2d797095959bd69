"""The port's phase timer and profiler trace (`gseg_tpu_torch.utils.timing`)
on the CPU, against `gseg_tpu.utils.timing`.

- `PhaseTimer` accumulates repeated phases and prints the same `json()` as
  the reference's for phases that carry no result (a scripted clock for
  both); a CPU tensor result is not waited for (`torch.cuda.synchronize`
  is never called), and `wait` likewise passes CPU tensors and host
  values.
- `profile_trace` writes a Chrome trace on the CPU and yields the
  profiler, whose events hold the block's ops; `device_seconds` is 0.0
  for a trace without a device.
The card's side (a CUDA result is waited for) is in tests/test_torch_cuda.py.
"""

import json
import time

import pytest

torch = pytest.importorskip("torch")

from gseg_tpu.utils import timing as ref_timing  # noqa: E402
from gseg_tpu_torch.utils import timing  # noqa: E402


def _scripted(monkeypatch, durations):
    """perf_counter advances by the next duration at every second read."""
    ticks = [0.0]
    for d in durations:
        ticks += [ticks[-1], ticks[-1] + d]
    it = iter(ticks[1:])
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


PHASES = (("prep", 0.125), ("segment", 0.5), ("prep", 0.25),
          ("render", 1e-6))


@pytest.mark.parametrize("module", [timing, ref_timing],
                         ids=["port", "reference"])
def test_phase_timer_accumulates(monkeypatch, module):
    _scripted(monkeypatch, [d for _, d in PHASES])
    timer = module.PhaseTimer()
    for name, _ in PHASES:
        with timer.phase(name):
            pass
    assert timer.phases == pytest.approx(
        {"prep": 0.375, "segment": 0.5, "render": 1e-6})
    assert json.loads(timer.json()) == {"prep": 0.375, "segment": 0.5,
                                        "render": 0.0}


def test_phase_timer_json_equals_reference(monkeypatch):
    out = []
    for module in (timing, ref_timing):
        _scripted(monkeypatch, [d for _, d in PHASES])
        timer = module.PhaseTimer()
        for name, _ in PHASES:
            with timer.phase(name):
                pass
        out.append(timer.json())
    assert out[0] == out[1]


def test_cpu_results_are_not_waited_for(monkeypatch):
    def no_sync(*a):
        raise AssertionError("synchronize called for a CPU result")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    timer = timing.PhaseTimer()
    with timer.phase("segment") as out:
        out["result"] = torch.arange(6).reshape(2, 3)
    with timer.phase("host") as out:
        out["result"] = 3
    assert set(timer.phases) == {"segment", "host"}
    assert all(v >= 0 for v in timer.phases.values())
    timing.wait((torch.zeros(2), None, 1.5))
    timing.wait([])


def test_profile_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with timing.profile_trace(str(log_dir)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    traces = list(log_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names
    assert "aten::matmul" in {e.key for e in prof.key_averages()}
    assert timing.device_seconds(prof) == 0.0

"""The atomic deployment and the 8K rung in the benchmark, on the CPU at a
tiny size: the harness takes `atomic-speed` x `blobs-4k` (`atomic-4k`)
and `turbo-speed` x `blobs-8k` (`speed-8k`); a round's least bytes; the
four atomic readers read a traced atomic run (the span readers the
program's device-time counters, which on the CPU are the spans' own
times; the roofline only on a card), read the right value from a stub
trace and leave their metrics out when the program recorded nothing."""

import io
import json

import pytest
import torch

from segbench import harness, program, reference, spec
from segbench.layers.atomic_round_bytes import round_bytes
from segbench.trace import Trace

ATOMIC = ("atomic_graph_ms", "atomic_rounds_ms", "atomic_rounds_per_frame",
          "atomic_round_roofline")
# the older metrics that read on any path
ANY_PATH = ("host_reads_per_frame", "device_idle_share",
            "device_ms_per_frame", "device_ops_per_frame", "host_wait_ms")
CARD = "NVIDIA H100 80GB HBM3"


def run_line(root, workload, trace):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, 3_000_000_019, 0.5, trace, root=root,
                     device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


@pytest.mark.parametrize("workload,config,shape", [
    ("atomic-4k", "atomic-speed", (2160, 3840)),
    ("speed-8k", "turbo-speed", (4320, 7680))])
def test_check_cell_takes_the_new_cell(workload, config, shape):
    c = spec.cell(workload)
    harness.check_cell(c["config"], c["traffic"])
    assert c["entry"]["chips"] == 1 and c["entry"]["config"] == config
    t = c["traffic"]
    assert (t["height"], t["width"]) == shape
    assert t["num_blobs"] == max(8, shape[0] * shape[1] // 65536)


def test_atomic_speed_is_turbo_speed_on_the_atomic_path():
    atomic = spec.cell("atomic-4k")
    turbo = spec.cell("speed-4k")["config"]
    cfg = atomic["config"]
    assert cfg["algorithm"] == "atomic" and "gossip_rounds" not in cfg
    same = set(reference.KEYS) | set(harness.FIXED) - {"hierarchy_levels"}
    assert {k: cfg[k] for k in same} == {k: turbo[k] for k in same}
    assert cfg["reduced"] == []
    names = [m["name"] for m in atomic["per_layer"]]
    assert sorted(names) == sorted(ATOMIC + ANY_PATH)


def test_speed_8k_reports_what_the_turbo_cells_report():
    eight = [m["name"] for m in spec.cell("speed-8k")["per_layer"]]
    assert eight == [m["name"] for m in spec.cell("quality-4k")["per_layer"]]
    assert len(eight) == 11


def test_round_bytes():
    assert round_bytes(2160, 3840) == 331_776_000
    assert round_bytes(1, 1) == 40


def test_atomic_readers_read_a_traced_atomic_run(tiny_root):
    line, err = run_line(tiny_root, "atomic-4k", True)
    assert line["correct"] is True
    got = line["metrics"]
    # on the CPU the roofline and the device readers find nothing
    assert set(got) == {"atomic_graph_ms", "atomic_rounds_ms",
                        "atomic_rounds_per_frame", "host_reads_per_frame",
                        "host_wait_ms"}
    assert got["atomic_graph_ms"]["value"] > 0
    assert got["atomic_rounds_ms"]["value"] > 0
    rounds = got["atomic_rounds_per_frame"]
    assert rounds["unit"] == "rounds/frame" and rounds["value"] >= 2
    # one read a round, and no other
    assert got["host_reads_per_frame"]["value"] == rounds["value"]
    assert got["host_wait_ms"]["value"] > 0
    gaps = [name for name, _ in line["breakdown"]["idle_gaps"]]
    assert any(g.startswith("gseg.") for g in gaps), gaps


def test_atomic_metrics_left_out_untraced_and_without_tracing(tiny_root,
                                                              monkeypatch):
    line, _ = run_line(tiny_root, "atomic-4k", False)
    assert not set(ATOMIC) & set(line["metrics"])
    monkeypatch.setattr(program, "_timing", lambda: None)
    line, err = run_line(tiny_root, "atomic-4k", True)
    assert line["correct"] is True
    assert not set(ATOMIC) & set(line["metrics"])
    for name in ATOMIC:
        assert f"{name}: nothing to wrap" in err


def _stub(counters, nbytes=0, card=True):
    tr = Trace("cpu")
    tr.frames = 4
    tr.program_counters = counters
    tr.counters["atomic_round_bytes"] = nbytes
    if card:
        tr.device, tr.kind = torch.device("cuda"), CARD
    return tr


@pytest.mark.parametrize("name", ATOMIC)
def test_atomic_reader_reads_none_when_the_program_recorded_nothing(name):
    assert spec.layer_reader(name).read(_stub({}, 10**9)) is None


STUB = {"device_ns.gseg.atomic_graph": 8_000_000,
        "device_ns.gseg.atomic_rounds": 400_000_000,
        "atomic.rounds.felz": 60, "atomic.rounds.minsize": 14}
# 74 rounds over 4 frames at 4K: 24.55 GB; 100 ms of rounds a frame on the card
WANT = {"atomic_graph_ms": 2.0, "atomic_rounds_ms": 100.0,
        "atomic_rounds_per_frame": 18.5,
        "atomic_round_roofline":
            100.0 * 74 * 331_776_000 / 3.35e12 / 0.4}


@pytest.mark.parametrize("name", ATOMIC)
def test_atomic_reader_reads_a_stub_trace(name):
    tr = _stub(dict(STUB), 74 * round_bytes(2160, 3840))
    assert spec.layer_reader(name).read(tr) == pytest.approx(WANT[name])


def test_atomic_rounds_from_one_phase_and_roofline_only_on_a_card():
    reader = spec.layer_reader("atomic_rounds_per_frame")
    assert reader.read(_stub({"atomic.rounds.felz": 6})) == 1.5
    roof = spec.layer_reader("atomic_round_roofline")
    assert roof.read(_stub(dict(STUB), 10**9, card=False)) is None
    assert roof.read(_stub(dict(STUB), 0)) is None

"""The harness on the CPU at a tiny size: its last line, discovery by
name, the checks failing on a broken timed path and on the controls, and
no module of JAX or of the JAX package in the process."""

import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from segbench import check, control, harness, spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_line(root, workload="speed-1080p", seconds=0.5, trace=False,
             **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, 12345678901, seconds, trace, root=root,
                     device="cpu", out=out, err=err, **kw)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return line, err.getvalue().strip().splitlines()


def test_last_line_keys_end_to_end(tiny_root):
    line, err = run_line(tiny_root)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert "breakdown" not in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    names = [m["name"] for m in spec.load(tiny_root)["end_to_end"]]
    assert sorted(line["metrics"]) == sorted(names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # the numbers compared: last on stderr, each beside its limit
    assert err[-3:] == check.lines(line["checks"])
    assert line["checks"]["pixels_off"] == {"value": 0, "limit": 0}


def test_last_line_keys_traced(tiny_root):
    line, _ = run_line(tiny_root, "quality-1080p", trace=True)
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the device readers find nothing and are left out
    assert "device_idle_share" not in line["metrics"]
    assert "step_roofline" not in line["metrics"]
    assert line["metrics"]["stage_g_ms"]["value"] > 0
    assert line["metrics"]["stage2_ms"]["value"] > 0


def test_discovery_by_name(tiny_root):
    """A stub mix and a stub metric, as new files and new entries only."""
    bench_dir = tiny_root / "segbench"
    (bench_dir / "traffic" / "stub-mix.json").write_text(json.dumps({
        "name": "stub-mix", "content": "blobs", "height": 24, "width": 40,
        "num_blobs": 3, "noise": 8.0, "pool": 3, "loop": "closed",
        "callers": 1}))
    (bench_dir / "layers" / "stub.metric.py").write_text(
        "def instrument(tr):\n    return True\n\n"
        "def read(tr):\n    return float(tr.frames)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "stub-cell", "config": "turbo-speed",
                               "traffic": "stub-mix", "chips": 1,
                               "why": "a stub"})
    bench["per_layer"].append({"name": "stub.metric", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "a stub", "moves": "mpix_per_s",
                               "workloads": ["stub-cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("stub-cell", tiny_root)
    assert c["traffic"]["name"] == "stub-mix"
    assert [m["name"] for m in c["per_layer"]] == ["stub.metric"]
    line, _ = run_line(tiny_root, "stub-cell", trace=True)
    assert line["correct"] is True
    assert line["metrics"] == {"stub.metric": {
        "value": float(line["attempted"]), "unit": "frames"}}
    # the other cells do not report it
    assert "stub.metric" not in [m["name"] for m in
                                 spec.cell("speed-1080p", tiny_root)[
                                     "per_layer"]]


def add_cell(root, name, changes, traffic="blobs-1080p"):
    """A cell `name` over a configuration of its own: turbo-speed's file
    with `changes` (a value None takes the key out), as new files and
    new entries only."""
    config = json.loads((root / "segbench/configs/turbo-speed.json")
                        .read_text())
    config.update(changes, name=name)
    config = {k: v for k, v in config.items() if v is not None}
    (root / "segbench/configs" / f"{name}.json").write_text(
        json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "a stub",
                             "file": f"segbench/configs/{name}.json",
                             "reduced": [], "why": "a stub"})
    bench["workloads"].append({"name": name, "config": name,
                               "traffic": traffic, "chips": 1,
                               "why": "a stub"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


NOT_TURBO = {"gossip_rounds": None}  # a key only the turbo path reads
REFUSALS = [
    ("traffic/blobs-1080p.json", "loop", "open", {}),
    ("traffic/blobs-1080p.json", "callers", 2, {}),
    ("traffic/blobs-1080p.json", "rate_hz", 30, {}),
    ("configs/turbo-speed.json", "precision", "bfloat16", {}),
    ("configs/turbo-speed.json", "quantize_weight_bits", 16, {}),
    ("configs/turbo-speed.json", "hierarchy_levels", 4, {}),
    ("configs/turbo-speed.json", "algorithm", "superpixel", NOT_TURBO),
    ("configs/turbo-speed.json", "algorithm", "boruvka_cpu", NOT_TURBO),
    ("configs/turbo-speed.json", "algorithm", "kruskal_cpu", NOT_TURBO),
    ("configs/turbo-speed.json", "algorithm", "kruskal_native", NOT_TURBO),
    ("configs/turbo-speed.json", "algorithm", "atomic_hostsync", NOT_TURBO),
    ("configs/turbo-speed.json", "weight_buckets", 16,
     NOT_TURBO | {"algorithm": "atomic"}),
    ("configs/turbo-speed.json", "weight_buckets", 16,
     NOT_TURBO | {"algorithm": "fastmst"}),
    ("configs/turbo-speed.json", "gossip_rounds", 2,
     {"algorithm": "fastmst"}),
]


@pytest.mark.parametrize("file, key, value, base", REFUSALS, ids=[
    "-".join([f, k, str(v)] + [f"no-{bk}" if bv is None else f"{bk}={bv}"
                               for bk, bv in b.items()])
    for f, k, v, b in REFUSALS])
def test_what_the_harness_does_not_implement_is_refused(tiny_root,
                                                        monkeypatch, file,
                                                        key, value, base):
    """A mix or configuration that asks for something the harness does not
    implement, or that its path would refuse frame by frame, stops the
    run before any frame, with no result, naming the key (and, for an
    algorithm, why)."""
    import gseg_tpu_torch

    path = tiny_root / "segbench" / file
    data = json.loads(path.read_text())
    data.update(base | {key: value})
    data = {k: v for k, v in data.items() if v is not None}
    path.write_text(json.dumps(data))
    called = []
    monkeypatch.setattr(gseg_tpu_torch, "segment",
                        lambda *a, **kw: called.append(a))
    with pytest.raises(ValueError, match=key) as e:
        run_line(tiny_root)
    assert called == []
    if key == "algorithm":
        assert harness.REFUSED[value] in str(e.value)


@pytest.mark.parametrize("fault", [None, "answer_altered", "half_left_out"])
@pytest.mark.parametrize("algorithm", ["atomic", "fastmst"])
def test_atomic_and_fastmst_held_to_the_reference(tiny_root, monkeypatch,
                                                  algorithm, fault):
    """The other exact device paths run through the harness as a
    configuration's file chooses them; their root-id labels read 0 pixels
    off, and an altered answer reads not correct."""
    import gseg_tpu_torch

    add_cell(tiny_root, f"{algorithm}-speed",
             NOT_TURBO | {"algorithm": algorithm})
    ran = set()
    segment = gseg_tpu_torch.segment

    def recorded(*a, config, **kw):
        ran.add(config.algorithm)
        return segment(*a, config=config, **kw)

    wrap = {None: lambda f: f, "answer_altered": _alter_one_pixel,
            "half_left_out": _top_half_only}[fault]
    monkeypatch.setattr(gseg_tpu_torch, "segment", wrap(recorded))
    line, _ = run_line(tiny_root, f"{algorithm}-speed")
    assert ran == {algorithm}
    c = line["checks"]
    assert c["frames_checked"]["value"] >= 2 and c["frames_failed"][
        "value"] == 0
    if fault is None:
        assert line["correct"] is True and c["pixels_off"]["value"] == 0
    else:
        assert line["correct"] is False and c["pixels_off"]["value"] > 0


def test_textured_mix_on_turbo_is_correct(tiny_root):
    (tiny_root / "segbench/traffic/textured-stub.json").write_text(
        json.dumps({"name": "textured-stub", "content": "textured",
                    "height": 48, "width": 64, "pool": 2, "loop": "closed",
                    "callers": 1}))
    add_cell(tiny_root, "textured-cell", {}, traffic="textured-stub")
    line, _ = run_line(tiny_root, "textured-cell")
    assert line["correct"] is True
    assert line["checks"]["pixels_off"] == {"value": 0, "limit": 0}


def test_every_named_file_exists():
    bench = spec.load()
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c["config"]["name"] == w["config"]
        assert c["traffic"]["name"] == w["traffic"]
        for m in c["per_layer"]:
            reader = spec.layer_reader(m["name"])
            assert callable(reader.instrument) and callable(reader.read)


def _alter_one_pixel(segment):
    def altered(*a, **kw):
        labels = segment(*a, **kw).clone()
        labels[0, 0] = -1
        return labels
    return altered


def _top_half_only(segment):
    def half(image, *a, **kw):
        top = segment(image[: image.shape[0] // 2], *a, **kw)
        h, w = image.shape[:2]
        out = torch.arange(h * w, dtype=torch.int32).reshape(h, w)
        out[: top.shape[0]] = top
        return out
    return half


def _state_unchanged(s2_round):
    def unchanged(st, *a, **kw):
        # a stage-2 round that returns its state as it came, converged
        return st._replace(merged=False, it=st.it + 1)
    return unchanged


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out",
                                   "state_unchanged"])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    import gseg_tpu_torch
    from gseg_tpu_torch.models import turbo

    if fault == "answer_altered":
        monkeypatch.setattr(gseg_tpu_torch, "segment",
                            _alter_one_pixel(gseg_tpu_torch.segment))
    elif fault == "half_left_out":
        monkeypatch.setattr(gseg_tpu_torch, "segment",
                            _top_half_only(gseg_tpu_torch.segment))
    else:
        monkeypatch.setattr(turbo, "_s2_round",
                            _state_unchanged(turbo._s2_round))
    line, err = run_line(tiny_root)
    assert line["correct"] is False
    c = line["checks"]
    assert c["pixels_off"]["value"] > 0 or c["frames_failed"]["value"] > 0
    assert err[-3].startswith("check pixels_off")


def test_minsize_control_is_not_correct(tiny_root):
    res = control.program_control("speed-1080p", 5, 0.5, "minsize",
                                  root=tiny_root, device="cpu")
    assert res["correct"] is False
    assert res["checks"]["pixels_off"]["value"] > 0


def test_bf16_control_reads_a_number(tiny_root):
    res = control.bf16_control("quality-1080p", 5, root=tiny_root)
    assert res["checks"]["frames_checked"]["value"] == 2
    assert res["checks"]["pixels_off"]["value"] >= 0


def test_no_chip_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    proc = subprocess.run([sys.executable, "segbench/run.py", "--workload",
                           "speed-1080p", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=spec.ROOT,
                          capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_jax_in_the_process(tiny_root):
    """A whole run, traced, in a fresh process: no module whose top-level
    name is jax, jaxlib, flax or gseg_tpu (compared whole: gseg_tpu_torch
    begins with gseg_tpu)."""
    code = (
        "import io, sys\n"
        "from segbench import harness\n"
        "rc = harness.run('speed-photos', 3, 0.3, True,"
        f" root={str(tiny_root)!r}, device='cpu', out=io.StringIO(),"
        " err=io.StringIO())\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(rc, sorted(top & {'jax', 'jaxlib', 'flax', 'gseg_tpu'}),"
        " 'gseg_tpu_torch' in top)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                          capture_output=True, text=True)
    assert proc.stdout.split("\n")[-2] == "0 [] True", proc.stderr


def test_forbidden_names_compared_whole():
    assert "gseg_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert {"gseg_tpu.models".split(".")[0]} <= harness.FORBIDDEN


@pytest.mark.cuda
def test_speed_photos_correct_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, "segbench/run.py", "--workload",
                           "speed-photos", "--seed", "17", "--seconds", "2",
                           "--trace", "1"], cwd=spec.ROOT,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["step_roofline"]["value"] <= 100
    assert np.isfinite(line["metrics"]["device_idle_share"]["value"])

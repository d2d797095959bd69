"""The port's evidence and A/B tooling against the reference's scripts.

- `bench.sweep` (port of `scripts/sweep_knobs.py`) runs each config in
  this process: every attribute that its CONFIGS name is reset to its
  import-time default, the config's attributes are set, and all of them
  are put back as they were afterwards, also when the config raises. Its
  configs are the reference's less the dropped per-phase T and strip
  rows; each names the reference's variables; a flagged config is an
  error row and a partition off the oracle an "ORACLE MISMATCH" row.
- `bench.evidence --sections quality` (port of `scripts/run_evidence.py`'s
  `section_quality`) gives, on the first 3 images of the synthetic set,
  each algorithm's ASA and UE equal (==) to the reference's record
  `bench_out/quality.jsonl`.
- `bench.summarize` (port of `scripts/summarize_evidence.py`) prints the
  reference script's tables: on the reference's records they are its
  tables with the median columns added, and on the port's rows too.
- Each entry runs on cuda:0 unless --device cpu is given, and raises
  without a card.

Tolerance: exact.
"""

import ast
import importlib.util
import json
import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models.boruvka_cpu import segment_boruvka_np  # noqa: E402
from gseg_tpu_torch.bench import evidence, summarize, sweep  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402
from gseg_tpu_torch.utils.labels import canonical_min_labels_np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORDS = ROOT / "bench_out"
SHAPE = (48, 64)


def _reference_script(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _attrs():
    return {key: getattr(*sweep._split(key)) for key in sweep.DEFAULTS}


def _oracle(wb):
    img = sweep.image(*SHAPE)
    cfg = sweep.config(wb)
    return canonical_min_labels_np(segment_boruvka_np(
        img, RefConfig(sigma=cfg.sigma, k=cfg.k, min_size=cfg.min_size,
                       max_iters=cfg.max_iters, weight_buckets=wb)))


def test_configs_are_the_references_less_the_dropped():
    ref = _reference_script("sweep_knobs")
    assert set(sweep.CONFIGS) | set(sweep.DROPPED) == set(ref.CONFIGS)
    assert not set(sweep.CONFIGS) & set(sweep.DROPPED)
    assert sweep.ENV == {n: ref.CONFIGS[n] for n in sweep.CONFIGS}
    # every dropped config sets only a per-phase T or a TPU strip height
    for name in sweep.DROPPED:
        assert {k for k in ref.CONFIGS[name]} <= {
            "GSEG_T_LATE", "GSEG_T_PEEL", "GSEG_SKIP_ROWS", "GSEG_GATE_DIV"}
    assert sweep.DEFAULTS == {
        "turbo._S2_SMALL": True, "turbo._EX_SMALL": True,
        "turbo._RLIST_SPLIT": True, "turbo._GATE_DIV": 128,
        "turbo._LATE_CLOSURES": False, "turbo._PEEL_SIZES": "subsum",
        "gossip.PAD_MIN_WIDTH": 2560, "turbo._FLOOD_PTR": False,
        "turbo._FINAL_GATHER": False, "turbo._GATE_DIV_Q": 32,
        "turbo._Q_CLOSURES": True}


@pytest.mark.parametrize("wb", [0, 16])
def test_sweep_restores_every_attribute(monkeypatch, wb):
    """Each config sees the defaults plus its own attributes while it
    runs; afterwards every attribute is as before the sweep (here: not the
    defaults), after an exact row, a flagged row and a raise alike."""
    monkeypatch.setattr(turbo, "_GATE_DIV", 64)
    monkeypatch.setattr(turbo, "_Q_CLOSURES", False)
    monkeypatch.setattr(kg, "PAD_MIN_WIDTH", 4096)
    before = _attrs()
    seen = []
    flagged = turbo.segment_turbo_flagged

    def rec(img, cfg, rounds):
        seen.append(_attrs())
        return flagged(img, cfg, rounds)

    monkeypatch.setattr(turbo, "segment_turbo_flagged", rec)
    img = torch.from_numpy(sweep.image(*SHAPE))
    oracle = _oracle(wb)
    names = sweep.QUALITY_CONFIGS if wb else [
        n for n in sweep.CONFIGS if n not in sweep.QUALITY_CONFIGS]
    for name in ("baseline", *names):
        seen.clear()
        row = sweep.run_config(name, img, wb, 1, oracle)
        assert _attrs() == before, name
        assert seen and all(s == sweep.DEFAULTS | sweep.CONFIGS[name]
                            for s in seen), name
        assert row["card"] == "cpu" and row["config"] == name
        assert row["env"] == sweep.ENV[name]
        assert set(row["launches"]) >= {"gossip_compmin", "pad_fields"}
        assert "error" not in row, row
        assert row["flags"] == 0 and row["oracle_equal"] is True
        assert len(seen) == 3  # warm-up, _timed's warm-up, one rep

    def boom(img, cfg, rounds):
        seen.append(_attrs())
        raise RuntimeError("boom")

    monkeypatch.setattr(turbo, "segment_turbo_flagged", boom)
    seen.clear()
    name = names[-1]
    row = sweep.run_config(name, img, wb, 1, oracle)
    assert row["error"] == "RuntimeError: boom"
    assert seen == [sweep.DEFAULTS | sweep.CONFIGS[name]]
    assert _attrs() == before


def test_sweep_rows_gate_on_flags_and_oracle(monkeypatch):
    """A flagged checked call is the error row `segment_turbo` raises on
    it (flags kept); a partition off the oracle is an ORACLE MISMATCH row;
    neither is timed."""
    img = torch.from_numpy(sweep.image(*SHAPE))
    oracle = _oracle(0)
    flagged = turbo.segment_turbo_flagged
    bits = turbo.FLAG_PAIR_OVERFLOW | turbo.FLAG_COMP_OVERFLOW
    monkeypatch.setattr(turbo, "segment_turbo_flagged",
                        lambda *a: (flagged(*a)[0], bits))
    row = sweep.run_config("baseline", img, 0, 1, oracle)
    assert row["flags"] == bits
    assert row["error"] == (
        "RuntimeError: turbo capacity/budget violation: pair-extraction "
        "capacity overflow; component-head capacity overflow")
    assert "median_ms" not in row and "oracle_equal" not in row
    monkeypatch.undo()
    wrong = oracle.copy()
    wrong[0, 0] = wrong.max() + 1
    row = sweep.run_config("finalgather", img, 0, 1, wrong)
    assert row["flags"] == 0 and row["oracle_equal"] is False
    assert row["error"] == "ORACLE MISMATCH" and "median_ms" not in row


def test_sweep_main_writes_the_references_row_keys(tmp_path):
    out = tmp_path / "sweep.jsonl"
    rows = sweep.main(["--shapes", "48x64", "--configs",
                       "baseline,nosmall,nofastpad", "--reps", "1",
                       "--no-oracle", "--out", str(out), "--device", "cpu"])
    assert [json.loads(line) for line in out.read_text().splitlines()] == rows
    ref_keys = {"config", "knobs", "height", "width", "weight_buckets",
                "wall_s", "mean_ms", "min_ms", "mpix_per_s"}
    for row in rows:
        assert ref_keys | {"warm_s", "median_ms", "card", "launches"} <= set(
            row)
        assert row["flags"] == 0 and "oracle_equal" not in row
    assert len({r["labels_sha256"] for r in rows}) == 1
    with pytest.raises(SystemExit, match="dropped"):
        sweep.main(["--configs", "tlate16", "--device", "cpu"])


def test_entries_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.main(["--shapes", "48x64", "--out", str(tmp_path / "s.jsonl")])
    with pytest.raises(RuntimeError, match="CUDA"):
        evidence.main(["--sections", "quality", "--out", str(tmp_path)])
    assert not (tmp_path / "s.jsonl").exists()


def test_ladders_and_quality_algos_are_the_references():
    """Read from the reference script's source (importing it would turn
    on its persistent compilation cache)."""
    tree = ast.parse((ROOT / "scripts" / "run_evidence.py").read_text())
    ref = {node.targets[0].id: ast.literal_eval(node.value)
           for node in tree.body if isinstance(node, ast.Assign)
           and getattr(node.targets[0], "id", None) in (
               "LADDERS", "QUALITY_ALGOS")}
    assert evidence.LADDERS == ref["LADDERS"]
    assert evidence.QUALITY_ALGOS == ref["QUALITY_ALGOS"]


def test_quality_section_equals_the_record(tmp_path):
    """Three images of the synthetic set, seven algorithms: ASA and UE
    equal to the reference's record, row for row."""
    rc = evidence.main(["--sections", "quality", "--quality-n", "3",
                        "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    rows = [json.loads(line) for line in
            (tmp_path / "quality.jsonl").read_text().splitlines()]
    record = {(r["image"], r["algorithm"]): r for r in map(
        json.loads, (RECORDS / "quality.jsonl").read_text().splitlines())}
    assert len(rows) == 3 * len(evidence.QUALITY_ALGOS)
    assert [(r["image"], r["algorithm"]) for r in rows] == [
        (f"synthetic{i:03d}", name) for name, _ in evidence.QUALITY_ALGOS
        for i in range(3)]
    for r in rows:
        ref = record[r["image"], r["algorithm"]]
        assert (r["asa"], r["ue"]) == (ref["asa"], ref["ue"]), r
        assert r["card"] == "cpu" and r["fallback"] is False


def test_superpixel_ladder_oracles_cover_the_rungs():
    """The superpixel rows of the ladder are held by the level oracles'
    level 4 (its final map); the other rows by partition oracles."""
    for h, w in ((540, 960), (720, 1280), (1080, 1920)):
        assert evidence.oracle_source("superpixel", "blobs", h, w) == \
            f"levels_dpp_blobs_{h}x{w}"
    for name, rungs, extra, content in evidence.LADDERS:
        for i in rungs:
            h, w = evidence.harness.RESOLUTION_LADDER[i]
            assert evidence.oracle_source(name, content, h, w) is not None, (
                name, content, h, w)


def _drop_column(table, header):
    """The markdown table without the column named `header`."""
    lines = table.split("\n")
    cells = lines[0].split(" | ")
    i = cells.index(header)
    out = []
    for line in lines:
        if not line.startswith("|"):
            out.append(line)
            continue
        parts = line.split("|")
        del parts[i + 1]
        out.append("|".join(parts))
    return "\n".join(out)


def test_summarize_prints_the_reference_tables(tmp_path, capsys):
    ref = _reference_script("summarize_evidence")
    for name in summarize.RECORDS:
        shutil.copy(RECORDS / name, tmp_path / name)
    load = summarize._load
    perf = load(tmp_path / "perf.jsonl")
    swp = load(tmp_path / "sweep.jsonl")
    # the reference's rows: its tables, plus the empty median columns
    assert _drop_column(summarize.perf_table(perf), "median ms") == \
        ref.perf_table(perf)
    assert _drop_column(summarize.sweep_table(swp), "median ms") == \
        ref.sweep_table(swp)
    for fname in ("quality.jsonl", "bsds_quality.jsonl"):
        rows = load(tmp_path / fname)
        assert summarize.quality_table(rows, "x") == ref.quality_table(
            rows, "x")
    batch = load(tmp_path / "batch.jsonl")
    assert summarize.batch_table(batch) == ref.batch_table(batch)
    # the port's rows beside them: timed rows give a median
    port = sweep.main(["--shapes", "48x64", "--configs", "baseline,gate13",
                       "--reps", "1", "--no-oracle", "--device", "cpu",
                       "--out", str(tmp_path / "sweep.jsonl")])
    capsys.readouterr()
    assert summarize.main(["--out", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert text.startswith("# Evidence summary\n")
    assert "Rows measured on: not recorded; cpu" in text
    table = summarize.sweep_table(load(tmp_path / "sweep.jsonl"))
    assert table in text
    line = table.split("\n")[2 + len(swp)]
    assert line.startswith("| baseline | 64x48 | 0 | ")
    assert f"| {port[0]['median_ms']:.1f} |" in line
    for title in ("## Performance ladder (perf.jsonl)",
                  "## Knob sweep (sweep.jsonl)",
                  "## Quality — BSDS-protocol stand-in (bsds_quality.jsonl)",
                  "## Quality — synthetic exact-GT set (quality.jsonl)",
                  "## Batch throughput (batch.jsonl)"):
        assert title in text
    assert "Promoted" not in text


def test_oracle_equal_holds_partitions_not_ids():
    """Root ids (atomic_hostsync) and canonical ids compare alike; a
    partition off by one pixel does not."""
    from gseg_tpu_torch import oracles

    want = oracles.load_oracle(oracles.oracle_path("blobs_540x960_wb16"))
    ids = np.where(want == 0, want.max() + 7, want)  # another id, same sets
    assert evidence.oracle_equal("turbo_wb16", "blobs", 540, 960, ids)
    off = want.copy()
    off[0, 0] = want.max() + 1
    assert not evidence.oracle_equal("turbo_wb16", "blobs", 540, 960, off)
    assert evidence.oracle_equal("turbo", "blobs", 96, 128, want) is None

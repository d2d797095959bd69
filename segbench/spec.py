"""Finds a cell's files by name: `BENCHMARK.json` at the root, the
configuration file it names, `segbench/traffic/<traffic>.json` and, for
each per-layer metric, `segbench/layers/<metric>.py`. A later change adds
a configuration, a mix or a metric as new files and new entries here,
without editing a file that is already there."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = "segbench"


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT) -> dict:
    """The cell named `workload`: its entry, its configuration and traffic
    as the files hold them, and the end-to-end and per-layer metrics it
    reports."""
    root = Path(root)
    bench = load(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(entries)}")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[entry["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / BENCH_DIR / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    return {
        "entry": entry,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"]
                       if _applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"]
                      if _applies(m, workload)],
    }


def layer_reader(metric: str, root: Path = ROOT):
    """The module of `segbench/layers/<metric>.py`: its `instrument(tr)`
    sets the traced run up (True if what it wraps is there) and its
    `read(tr)` returns the value, or None when it found nothing to read."""
    path = Path(root) / BENCH_DIR / "layers" / f"{metric}.py"
    mod_name = "segbench_layer_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {metric!r}:"
                                f" {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

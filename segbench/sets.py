"""Runs cells one after another, each run a process of its own, and
reports each metric's median and spread (the distance between the first
and third quartiles of `statistics.quantiles(values, n=4)`, over the
median): the measurement that sets a bound.

    python3 segbench/sets.py --workloads speed-1080p --seeds 1,2,3,4,5,6 \\
        --seconds 30 [--sets 2] [--trace 1] [--out sets.jsonl]

With --sets 2 the seeds run twice, as two sets, and each metric's line
gives both sets' spreads, their mean with each set's run farthest from
its median left out (what a bound has to be twice as wide as), and the
spread of all the runs (what a bound may be at most eight times).

Each run's result line (or its exit code and the end of its standard
error) goes to --out as one JSON object, with the workload, seed, trace
flag and wall seconds."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def trimmed(values) -> list:
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "segbench" / "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True)
    row = {"workload": workload, "seed": seed, "trace": trace,
           "rc": proc.returncode, "wall_s": time.perf_counter() - t,
           "stderr": proc.stderr[-3000:]}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        row["result"] = json.loads(lines[-1])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="segbench/sets.py")
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")] * a.sets
    bad = 0
    for wl in a.workloads.split(","):
        values: dict = {}
        for seed in seeds:
            row = one(wl, seed, a.seconds, a.trace)
            res = row.get("result")
            if a.out:
                Path(a.out).parent.mkdir(parents=True, exist_ok=True)
                with open(a.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            if res is None:
                bad += 1
                print(f"{wl} seed {seed}: rc {row['rc']}\n"
                      f"{row['stderr'][-1500:]}", flush=True)
                continue
            bad += not res["correct"]
            ms = {k: v["value"] for k, v in res["metrics"].items()}
            for k, v in ms.items():
                values.setdefault(k, []).append(v)
            print(f"{wl} seed {seed} correct {res['correct']} attempted "
                  f"{res['attempted']} failed {res['failed']} wall "
                  f"{row['wall_s']:.1f} s {json.dumps(ms)} "
                  f"checks {json.dumps(res['checks'])}", flush=True)
        for k, vs in values.items():
            line = (f"{wl} {k}: median {statistics.median(vs)!r} spread "
                    f"{spread(vs)!r} n {len(vs)}")
            n = len(vs) // a.sets
            if a.sets > 1 and n > 2 and len(vs) == n * a.sets:
                sets = [vs[i * n:(i + 1) * n] for i in range(a.sets)]
                meds = [statistics.median(x) for x in sets]
                tight = statistics.mean(spread(trimmed(x)) for x in sets)
                line += (f" set spreads {[spread(x) for x in sets]!r} set "
                         f"medians {meds!r} trimmed mean {tight!r}")
            print(f"{line} values {vs!r}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

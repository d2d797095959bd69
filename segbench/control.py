"""The controls of the comparison that decides `correct`: runs that must
come out as not correct, at the cell's own size.

    python3 segbench/control.py --workload speed-1080p --seeds 1,2,3 \\
        --kind minsize [--seconds 6]

kinds:
  bf16     the reference put in the program's place, computed in
           bfloat16 (the smoothed frame and the edge weights rounded), the
           precision below the float32 the configuration states; its
           partitions of the run's pool are held against the float32
           reference's. No window: the reference is the program here.
  minsize  the program with the min-size rounds off (`min_size=1`): it
           breaks the guarantee that every component holds min_size
           pixels, through a short window of the harness.

Each seed prints one line: the kind, the seed, `correct` and the numbers
compared. The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from segbench import check, frames, harness, spec  # noqa: E402

OVERRIDES = {"minsize": {"min_size": 1}}


def bf16_control(workload: str, seed: int, root=spec.ROOT) -> dict:
    """The bfloat16 reference in the program's place over the run's
    pool: {"correct", "checks"}."""
    c = spec.cell(workload, root)
    pool = dict(enumerate(frames.make_pool(c["traffic"], seed)))
    refs = check.reference_partitions(pool, c["config"])
    low = check.reference_partitions(pool, c["config"], "bfloat16")
    checks = check.compare([(i, low[i]) for i in pool], refs, 0)
    return {"correct": check.passed(checks), "checks": checks}


def program_control(workload: str, seed: int, seconds: float, kind: str,
                    root=spec.ROOT, device=None) -> dict:
    """A short harness window with the program's settings overridden:
    the result line (its `correct` and `checks`)."""
    out = io.StringIO()
    rc = harness.run(workload, seed, seconds, False, root=root,
                     device=device, program_overrides=OVERRIDES[kind],
                     out=out)
    if rc != 0:
        return {"correct": False, "rc": rc}
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="segbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", choices=("bf16", "minsize"),
                    required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    a = ap.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        if a.kind == "bf16":
            res = bf16_control(a.workload, seed)
        else:
            res = program_control(a.workload, seed, a.seconds, a.kind)
        print(json.dumps({"control": a.kind, "workload": a.workload,
                          "seed": seed, "correct": res["correct"],
                          "checks": res.get("checks"),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

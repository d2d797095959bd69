"""Benchmark CLI: `python -m gseg_tpu_torch.bench quality` (port of
`gseg_tpu.bench.__main__`).

`quality` runs the ASA/UE protocol on BSDS500 when --bsds-root (or
BSDS500_ROOT) points at it, else on `synthetic_quality_set`; it writes
<out-dir>/quality.jsonl and prints one summary line. It draws no plot.
The default --out-dir is the port's own, `bench_out/torch` (gitignored),
so that a run never overwrites the reference's records in `bench_out/`.
`--device` (default cuda:0; 'cpu' asks for the CPU) is the one flag the
reference lacks. `perf`, the resolution ladder, is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os

OUT_DIR = os.path.join("bench_out", "torch")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gseg_tpu_torch.bench")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("perf", help="resolution-ladder performance run (not "
                                "ported yet: ROADMAP.md queue 1, item 1)")

    qp = sub.add_parser("quality", help="ASA/UE quality run")
    qp.add_argument("--algorithms", default="turbo,kruskal_native")
    qp.add_argument("--bsds-root", default=os.environ.get("BSDS500_ROOT"))
    qp.add_argument("--split", default="val")
    qp.add_argument("--limit", type=int, default=None)
    qp.add_argument("--synthetic-n", type=int, default=20,
                    help="synthetic set size when BSDS500 is unavailable")
    qp.add_argument("--k", type=float, default=80.0)
    qp.add_argument("--min-size", type=int, default=100)
    qp.add_argument("--out-dir", default=OUT_DIR,
                    help=f"where quality.jsonl goes (default {OUT_DIR}; "
                         "the reference's records in bench_out/ stay as "
                         "they are)")
    qp.add_argument("--device", default=None,
                    help="torch device (default cuda:0; raises without a "
                         "CUDA device unless this is 'cpu')")

    args = p.parse_args(argv)
    if args.cmd == "perf":
        raise NotImplementedError(
            "the performance ladder is not ported yet (ROADMAP.md, queue 1, "
            "item 1)")

    from ..config import SegmentationConfig
    from ..utils import datasets
    from .harness import run_quality_benchmark, summarize_quality

    os.makedirs(args.out_dir, exist_ok=True)
    algorithms = tuple(a.strip() for a in args.algorithms.split(","))
    cfg = SegmentationConfig(k=args.k, min_size=args.min_size)
    if datasets.bsds500_available(args.bsds_root):
        samples = datasets.load_bsds500(args.bsds_root, args.split, args.limit)
        source = f"BSDS500:{args.split}"
    else:
        samples = datasets.synthetic_quality_set(n=args.synthetic_n)
        source = "synthetic"
    rows = run_quality_benchmark(
        samples, algorithms, cfg,
        out_path=os.path.join(args.out_dir, "quality.jsonl"),
        device=args.device,
    )
    print(json.dumps({"source": source, "summary": summarize_quality(rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

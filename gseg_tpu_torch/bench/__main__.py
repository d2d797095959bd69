"""Benchmark CLI: `python -m gseg_tpu_torch.bench {perf|quality}` (port of
`gseg_tpu.bench.__main__`).

`perf` runs the resolution ladder (rungs up to --max-mpix megapixels),
writes <out-dir>/perf.jsonl and prints one line per row. `quality` runs
the ASA/UE protocol on BSDS500 when --bsds-root (or BSDS500_ROOT) points
at it, else on `synthetic_quality_set`; it writes <out-dir>/quality.jsonl
and prints one summary line. Each draws its figure (perf.png, the Fig. 2
style; quality.png, Fig. 4) where matplotlib is installed, and otherwise
says in one line that it drew none; the timed run is the same either way.
The default --out-dir is the port's own, `bench_out/torch` (gitignored),
so that a run never overwrites the reference's records in `bench_out/`.
`--device` (default cuda:0; 'cpu' asks for the CPU) is the one flag the
reference lacks.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

OUT_DIR = os.path.join("bench_out", "torch")
_DEVICE_HELP = ("torch device (default cuda:0; raises without a CUDA device "
                "unless this is 'cpu')")


def _figure(plot, rows, png, jsonl, **kwargs) -> None:
    """Draw `png` with `plot` where matplotlib is installed; else say so."""
    if importlib.util.find_spec("matplotlib") is None:
        print(f"no figure drawn ({png}): matplotlib is not installed; the "
              f"rows are in {jsonl}")
        return
    plot(rows, png, **kwargs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gseg_tpu_torch.bench")
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("perf", help="resolution-ladder performance run")
    pp.add_argument("--algorithms", default="turbo")
    pp.add_argument("--max-mpix", type=float, default=9.0,
                    help="skip ladder rungs above this many megapixels")
    pp.add_argument("--reps", type=int, default=5)
    pp.add_argument("--k", type=float, default=300.0)
    pp.add_argument("--min-size", type=int, default=100)
    pp.add_argument("--out-dir", default=OUT_DIR,
                    help=f"where perf.jsonl goes (default {OUT_DIR})")
    pp.add_argument("--device", default=None, help=_DEVICE_HELP)

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
    qp.add_argument("--device", default=None, help=_DEVICE_HELP)

    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    from ..config import SegmentationConfig
    from . import plots

    algorithms = tuple(a.strip() for a in args.algorithms.split(","))
    cfg = SegmentationConfig(k=args.k, min_size=args.min_size)

    if args.cmd == "perf":
        from . import harness

        resolutions = [
            (h, w) for h, w in harness.RESOLUTION_LADDER
            if h * w / 1e6 <= args.max_mpix
        ]
        jsonl = os.path.join(args.out_dir, "perf.jsonl")
        rows = harness.run_performance_ladder(
            algorithms, resolutions, args.reps, cfg, out_path=jsonl,
            device=args.device,
        )
        _figure(plots.plot_performance, rows,
                os.path.join(args.out_dir, "perf.png"), jsonl,
                reference=plots.REFERENCE_TOTALS)
        for r in rows:
            print(json.dumps({
                "algorithm": r["algorithm"], "mpix": round(r["mpix"], 2),
                "total_ms": round(r["total"]["mean_s"] * 1e3, 1),
                "mpix_per_s": round(r["mpix_per_s"], 1),
            }))
        return 0

    # quality
    from ..utils import datasets
    from .harness import run_quality_benchmark, summarize_quality

    if datasets.bsds500_available(args.bsds_root):
        samples = datasets.load_bsds500(args.bsds_root, args.split, args.limit)
        source = f"BSDS500:{args.split}"
    else:
        samples = datasets.synthetic_quality_set(n=args.synthetic_n)
        source = "synthetic"
    jsonl = os.path.join(args.out_dir, "quality.jsonl")
    rows = run_quality_benchmark(samples, algorithms, cfg, out_path=jsonl,
                                 device=args.device)
    _figure(plots.plot_quality, rows,
            os.path.join(args.out_dir, "quality.png"), jsonl)
    print(json.dumps({"source": source, "summary": summarize_quality(rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

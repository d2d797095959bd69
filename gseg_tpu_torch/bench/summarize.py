"""One-command markdown summary of the evidence records (port of
`scripts/summarize_evidence.py`).

Turns `perf.jsonl`, `sweep.jsonl`, `bsds_quality.jsonl`, `quality.jsonl`
and `batch.jsonl` of --out (default `bench_out/torch`, what
`bench.evidence` and `bench.sweep` write) into the reference script's
tables, with the reference's GTX 1080 Ti totals (BASELINE.md Fig. 2) as
per-rung speedup columns. The port's timed rows carry a median beside the
reference's mean: the tables give both (the speedups at the mean, as the
reference's), and a row without a median (a record the reference wrote)
leaves its cell empty. The header lists the cards the rows were measured
on (name and power limit, as `nvidia-smi` gives them), so that no number
stands without its card. The reference's promoted-environment line is
left out: its knob promotion is not ported.

    python -m gseg_tpu_torch.bench.summarize [--out bench_out/torch]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .evidence import OUT_DIR

# the reference's totals by megapixels (bench/plots.py:REFERENCE_TOTALS)
REF_ATOMIC_S = {0.52: 0.0145, 2.07: 0.0513, 8.29: 0.182, 33.2: 0.7158}
REF_DPP_S = {0.52: 0.0294, 2.07: 0.0711, 8.29: 0.2422, 33.2: 0.9812}
RECORDS = ("perf.jsonl", "sweep.jsonl", "bsds_quality.jsonl",
           "quality.jsonl", "batch.jsonl")


def _load(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _ref_lookup(table, mpix):
    for k, v in table.items():
        if abs(k - mpix) / k < 0.12:
            return v
    return None


def _median_ms(stats):
    return f"{stats['median_s'] * 1e3:.1f}" if "median_s" in stats else ""


def perf_table(rows):
    out = ["| algorithm | content | resolution | MPix | total ms | median ms "
           "| MPix/s | vs ref atomic | vs ref DPP | knobs |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        res = f"{r.get('width', '?')}x{r.get('height', '?')}"
        if "error" in r:
            out.append(f"| {r.get('algorithm')} | {r.get('content', 'blobs')} "
                       f"| {res} | | ERROR: {r['error'][:80]} | | | | | |")
            continue
        h, w = r["height"], r["width"]
        mpix = h * w / 1e6
        ms = r["total"]["mean_s"] * 1e3
        mps = mpix / r["total"]["mean_s"]
        ra = _ref_lookup(REF_ATOMIC_S, mpix)
        rd = _ref_lookup(REF_DPP_S, mpix)
        va = f"{ra * 1e3 / ms:.2f}x" if ra else ""
        vd = f"{rd * 1e3 / ms:.2f}x" if rd else ""
        knobs = " ".join(f"{k.replace('GSEG_', '')}={v}"
                         for k, v in sorted(r.get("knobs", {}).items()))
        out.append(f"| {r['algorithm']} | {r.get('content', 'blobs')} | {res} "
                   f"| {mpix:.2f} | {ms:.1f} | {_median_ms(r['total'])} "
                   f"| {mps:.1f} | {va} | {vd} | {knobs} |")
    return "\n".join(out)


def sweep_table(rows):
    out = ["| config | shape | wb | compile s | mean ms | median ms | oracle "
           "| note |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        shape = f"{r.get('width', '?')}x{r.get('height', '?')}"
        # the port's warm-up seconds stand where the reference compiled
        warm = r.get("compile_s", "")
        if "warm_s" in r:
            warm = f"{r['warm_s']:.1f}"
        if "error" in r:
            out.append(f"| {r['config']} | {shape} | {r['weight_buckets']} "
                       f"| | | | | {r['error'][:60]} |")
            continue
        median = (f"{r['median_ms']:.1f}" if "median_ms" in r else "")
        mean = r.get("mean_ms", "")
        if isinstance(mean, float) and "median_ms" in r:
            mean = f"{mean:.1f}"
        out.append(f"| {r['config']} | {shape} | {r['weight_buckets']} "
                   f"| {warm} | {mean} | {median} "
                   f"| {r.get('oracle_equal', '')} | |")
    return "\n".join(out)


def quality_table(rows, label):
    algos = sorted({r["algorithm"] for r in rows if "asa" in r})
    out = [f"| algorithm | ASA median | UE median | n ({label}) |",
           "|---|---|---|---|"]
    for a in algos:
        asa = [r["asa"] for r in rows if r["algorithm"] == a and "asa" in r]
        ue = [r["ue"] for r in rows if r["algorithm"] == a and "ue" in r]
        out.append(f"| {a} | {np.median(asa):.4f} | {np.median(ue):.4f} "
                   f"| {len(asa)} |")
    errs = [r for r in rows if "error" in r]
    if errs:
        out.append(f"\n{len(errs)} errored rows.")
    return "\n".join(out)


def batch_table(rows):
    out = ["| resolution | batch | total ms | MPix/s |", "|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            out.append(f"| {r['width']}x{r['height']} | {r['batch']} | "
                       f"ERROR: {r['error'][:60]} | |")
        else:
            out.append(f"| {r['width']}x{r['height']} | {r['batch']} | "
                       f"{r['total']['mean_s'] * 1e3:.1f} "
                       f"| {r['mpix_per_s']:.1f} |")
    return "\n".join(out)


def cards(out_dir) -> list:
    """The cards the records' rows name, in order of first appearance;
    "not recorded" for rows without one (the reference's)."""
    seen = []
    for fname in RECORDS:
        for r in _load(os.path.join(out_dir, fname)):
            c = r.get("card", "not recorded")
            if c not in seen:
                seen.append(c)
    return seen


def summary(out_dir) -> str:
    o = out_dir
    parts = ["# Evidence summary\n",
             "Rows measured on: " + ("; ".join(cards(o)) or "no rows") + "\n"]
    perf = _load(os.path.join(o, "perf.jsonl"))
    if perf:
        parts += ["## Performance ladder (perf.jsonl)\n",
                  perf_table(perf) + "\n",
                  "Reference totals: atomic 51.3 ms @1080p / 182 ms @4K / "
                  "716 ms @8K; DPP 71.1 / 242 / 981 ms (BASELINE.md "
                  "Fig.2).\n"]
    sweep = _load(os.path.join(o, "sweep.jsonl"))
    if sweep:
        parts += ["## Knob sweep (sweep.jsonl)\n", sweep_table(sweep) + "\n"]
    for fname, label in (("bsds_quality.jsonl", "BSDS-protocol stand-in"),
                         ("quality.jsonl", "synthetic exact-GT set")):
        rows = _load(os.path.join(o, fname))
        if rows:
            parts += [f"## Quality — {label} ({fname})\n",
                      quality_table(rows, label) + "\n"]
    batch = _load(os.path.join(o, "batch.jsonl"))
    if batch:
        parts += ["## Batch throughput (batch.jsonl)\n",
                  batch_table(batch) + "\n"]
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gseg_tpu_torch.bench.summarize")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    print(summary(args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

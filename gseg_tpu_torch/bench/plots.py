"""Benchmark figure rendering, in the reference's Fig. 2 / Fig. 4 formats
(port of `gseg_tpu.bench.plots`).

Log-log runtime-against-resolution panels and ASA/UE box plots and CDFs,
kept in the reference report's format (branch correct-benchmark-plots,
reference README.md:24; docs/figure-data.md decodes the originals) so the
port's rows can be compared side by side with its figures. Each function
takes the rows that `bench.harness` writes. matplotlib is imported when a
figure is drawn, never with this module: a machine without it still runs
the benchmarks and keeps their JSONL.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def plot_performance(rows: List[dict], out_path: str,
                     reference: Dict[str, Dict[float, float]] | None = None):
    """Fig. 2 style: total runtime vs megapixels, log-log, one line per
    algorithm. `reference` optionally overlays the decoded reference
    numbers ({algo: {mpix: seconds}})."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    algos = sorted({r["algorithm"] for r in rows})
    for a in algos:
        pts = sorted(
            [(r["mpix"], r["total"]["mean_s"]) for r in rows
             if r["algorithm"] == a]
        )
        ax.plot([p[0] for p in pts], [p[1] for p in pts], "o-", label=a)
    if reference:
        for name, pts_d in reference.items():
            pts = sorted(pts_d.items())
            ax.plot([p[0] for p in pts], [p[1] for p in pts], "s--",
                    alpha=0.6, label=f"ref: {name}")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("megapixels")
    ax.set_ylabel("total runtime [s]")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    return out_path


# Decoded reference totals (BASELINE.md Fig. 2a; GTX 1080 Ti) keyed by MPix.
REFERENCE_TOTALS = {
    "ref atomic (1080 Ti)": {0.52: 0.0145, 2.07: 0.0513, 8.29: 0.182,
                             33.2: 0.7158},
    "ref DPP hier (1080 Ti)": {0.52: 0.0294, 2.07: 0.0711, 8.29: 0.2422,
                               33.2: 0.9812},
    "ref CPU baseline": {0.52: 0.482, 2.07: 2.60, 8.29: 12.78, 33.2: 58.98},
}


def plot_quality_cdf(rows: List[dict], out_path: str):
    """Appendix-B style: empirical CDFs of ASA (left) and UE (right) per
    algorithm (reference Report.pdf Appendix B, docs/figure-data.md)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    algos = sorted({r["algorithm"] for r in rows})
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4.5))
    for a in algos:
        for ax, key in ((ax1, "asa"), (ax2, "ue")):
            vals = np.sort([r[key] for r in rows if r["algorithm"] == a])
            cdf = np.arange(1, len(vals) + 1) / len(vals)
            ax.step(vals, cdf, where="post", label=a)
    ax1.set_title("ASA empirical CDF")
    ax1.set_xlabel("ASA")
    ax2.set_title("UE empirical CDF")
    ax2.set_xlabel("UE")
    for ax in (ax1, ax2):
        ax.set_ylabel("fraction of images")
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    return out_path


# Decoded reference Fig. 4 medians on real BSDS500 (docs/figure-data.md) —
# drawn as context lines. NOTE: our quality sets are synthetic stand-ins
# (BSDS500 unobtainable, see README caveat); absolute levels are not
# directly comparable, the between-algorithm ordering/gaps are.
REFERENCE_QUALITY_MEDIANS = {
    "ref CPU baseline": {"asa": 0.974, "ue": 0.051},
    "ref best GPU (GPU baseline)": {"asa": 0.941, "ue": 0.118},
    "ref DPP superpix": {"asa": 0.929, "ue": 0.142},
}


def plot_quality(rows: List[dict], out_path: str,
                 reference: Dict[str, Dict[str, float]] | None = None):
    """Fig. 4 style: ASA and UE box plots per algorithm. `reference`
    optionally overlays horizontal median context lines (e.g.
    REFERENCE_QUALITY_MEDIANS — see the synthetic-set caveat there)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    algos = sorted({r["algorithm"] for r in rows})
    asa = [[r["asa"] for r in rows if r["algorithm"] == a] for a in algos]
    ue = [[r["ue"] for r in rows if r["algorithm"] == a] for a in algos]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4.5))
    ax1.boxplot(asa, tick_labels=algos)
    ax1.set_title("Achievable Segmentation Accuracy")
    ax1.set_ylim(0, 1.05)
    ax2.boxplot(ue, tick_labels=algos)
    ax2.set_title("Undersegmentation Error")
    if reference:
        styles = ((":", 0.8), ("--", 0.6), ("-.", 0.5))
        for (name, med), (ls, al) in zip(reference.items(), styles):
            ax1.axhline(med["asa"], ls=ls, alpha=al, color="gray",
                        label=name)
            ax2.axhline(med["ue"], ls=ls, alpha=al, color="gray",
                        label=name)
        ax1.legend(fontsize=7, loc="lower left")
    for ax in (ax1, ax2):
        ax.tick_params(axis="x", rotation=30)
        ax.grid(True, axis="y", alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    return out_path

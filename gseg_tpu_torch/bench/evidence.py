"""Evidence campaign: the reference's figure set, with the port's rows
(port of `scripts/run_evidence.py`).

Sections (run in this order; each resumable: perf and eightk skip rungs
already measured without error, the others skip when their record exists,
unless --force):

  perf     the Fig. 2 ladder (reference README.md:25-28): LADDERS, the
           reference's per-algorithm rungs of RESOLUTION_LADDER, 20 reps
           each; one record per rung, written after every rung;
  eightk   the 8K turbo rung (4320x7680, 3 reps) in this process. The
           reference ran it in a subprocess with a 2.5 h cap and a
           GSEG_PALLAS=0 retry, guards for its TPU compile: the port
           compiles nothing per shape, and a retry on the kernels' plain
           versions would be a fallback, which the port does not have;
  fig3     `bench.fig3` with 100 reps (the conventional against the
           device-orchestrated loop; an A/A in the port, see fig3.py);
  quality  the synthetic quality set (`synthetic_quality_set`, n 20, exact
           ground truth) at k 30, min_size 10, on_overflow "fallback", the
           seven QUALITY_ALGOS; each row says whether the overflow policy
           routed it to the atomic path (`fallback`: the same partition);
  bsds     the reference's BSDS protocol (K 80, min_size 100, hierarchy
           level 4, quality mode on its final map) on BSDS500 where
           --bsds-root points at it, else on `bsds_like_quality_set`;
  batch    `segment_batch_flagged` at 1080p x 4 and 4K x 2, `_timed`
           with 3 reps;
  plots    Fig. 2 and Fig. 4 (box plots and CDFs) where matplotlib is
           installed, else one line that says so.

Every row carries `card` (the name and power limit of the card that ran
it, as `nvidia-smi` gives them, or "cpu"). Perf rows carry the ladder's
`flags` and, where a committed oracle covers the rung, `oracle_equal`:
the reference's `bench_out/oracle_bench_*.npy`, the port's
`gseg_tpu_torch/oracles/*.npz`, and for superpixel (whose final map is
its hierarchy's level 4, with no NumPy oracle) the level oracles
`levels_dpp_blobs_{540x960,720x1280,1080x1920}.json`.

The records go to --out (default `bench_out/torch`, gitignored); the
reference's records in `bench_out/` are read, never written.

Usage: python -m gseg_tpu_torch.bench.evidence [--out bench_out/torch]
       [--force] [--sections perf,fig3,quality,bsds,batch,eightk,plots]
       [--device cuda:0|cpu] [--quality-n 20] [--bsds-root DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..config import SegmentationConfig
from . import harness, sweep

OUT_DIR = os.path.join("bench_out", "torch")
SECTIONS = ("perf", "fig3", "quality", "bsds", "batch", "eightk", "plots")

# (algorithm, rung indices into RESOLUTION_LADDER, extra cfg kwargs, image
# content), the reference's (scripts/run_evidence.py:42-67)
LADDERS = [
    ("turbo", [0, 1, 2, 3, 4, 5], {}, "blobs"),
    ("turbo", [0, 2, 4], {}, "textured"),
    ("fastmst", [0, 1, 2], {}, "blobs"),
    ("superpixel", [0, 1, 2], {}, "blobs"),
    ("atomic", [0, 1, 2], {}, "blobs"),
    ("atomic_hostsync", [0], {}, "blobs"),
    ("turbo_wb16", [2, 4, 0], {"weight_buckets": 16}, "blobs"),
]
EIGHTK = (4320, 7680)

QUALITY_ALGOS = [
    ("turbo", {}),
    ("turbo_wb16", {"weight_buckets": 16}),
    ("fastmst", {}),
    ("atomic", {}),
    ("superpixel", {}),
    ("kruskal_native", {}),
    ("boruvka_cpu", {}),
]


def base_algo(name: str) -> str:
    return "turbo" if name.startswith("turbo") else name


def _load(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _done(path):
    return os.path.exists(path) and os.path.getsize(path) > 0


def _sha256(canonical):
    return hashlib.sha256(np.ascontiguousarray(
        canonical, np.int32).tobytes()).hexdigest()


def oracle_source(name: str, content: str, h: int, w: int):
    """The committed oracle of ladder entry `name` on the ladder image at
    (h, w): a partition file, or for superpixel a level oracle's name;
    None where none covers it."""
    from .. import oracles

    if name == "superpixel":
        level = f"levels_dpp_blobs_{h}x{w}"
        ok = content == "blobs" and level in oracles.LEVEL_ORACLES
        return level if ok else None
    wb = 16 if name == "turbo_wb16" else 0
    if content == "blobs":
        return sweep.oracle_file(h, w, wb)
    oname = f"{content}_{h}x{w}_wb{wb}"
    return oracles.oracle_path(oname) if oname in oracles.ORACLES else None


def oracle_equal(name: str, content: str, h: int, w: int, labels):
    """Whether `labels` (any ids) give the committed oracle's partition
    (`oracle_source`; superpixel: its level 4's canonical sha256); None
    where no oracle covers the rung."""
    from .. import oracles
    from ..utils.labels import canonical_min_labels_np

    source = oracle_source(name, content, h, w)
    if source is None:
        return None
    canon = canonical_min_labels_np(np.asarray(labels))
    if name == "superpixel":
        want = oracles.load_level_oracle(source)["superpixel"]["levels"][4]
        return _sha256(canon) == want["sha256"]
    return bool(np.array_equal(canon, oracles.load_oracle(source)))


def ladder_rows(name, rungs, extra, content, reps, device) -> list:
    """One ladder entry's rows at `rungs` ((h, w) pairs): the harness's
    rows with the entry's name, the card, and `oracle_equal` where an
    oracle covers the rung (one more call's labels). A rung that raises
    gives an error row."""
    from .. import _image_on

    cfg = SegmentationConfig(k=300.0, min_size=100, **extra)
    card = harness.card(device)
    rows = []
    for h, w in rungs:
        try:
            rs = harness.run_performance_ladder(
                algorithms=[base_algo(name)], resolutions=[(h, w)],
                reps=reps, cfg=cfg, content=content, device=device)
            img = _image_on(harness.ladder_image(h, w, content), device)
            labels = harness.segment_fn(base_algo(name), cfg,
                                        device=device)(img)
            equal = oracle_equal(name, content, h, w, labels.cpu().numpy())
            del img, labels
        except Exception as e:  # one bad rung must not lose the ladder
            msg = str(e).splitlines()[0][:300] if str(e) else repr(e)
            print(f"[perf] {name}@{(h, w)} FAILED: {msg}", flush=True)
            rows.append({"algorithm": name, "content": content,
                         "height": h, "width": w, "card": card,
                         "error": msg})
            continue
        for r in rs:
            r |= {"algorithm": name, "card": card}
            if equal is not None:
                r["oracle_equal"] = equal
        rows.extend(rs)
        print(f"[perf] {name}@{(h, w)} ok (median "
              f"{rs[0]['total']['median_s'] * 1e3:.3f} ms, flags "
              f"{rs[0]['flags']}, oracle_equal {equal}; {card})", flush=True)
    return rows


def section_perf(out_dir, device, reps=20, ladders=LADDERS) -> list:
    path = os.path.join(out_dir, "perf.jsonl")
    rows = _load(path)
    done = {(r.get("algorithm"), r.get("content", "blobs"), r.get("height"),
             r.get("width")) for r in rows if "error" not in r}
    for name, rungs, extra, content in ladders:
        t0 = time.time()
        todo = [harness.RESOLUTION_LADDER[i] for i in rungs]
        print(f"[perf] {name}/{content}: {len(todo)} rungs", flush=True)
        for res in todo:
            if (name, content, res[0], res[1]) in done:
                continue
            rows.extend(ladder_rows(name, [res], extra, content, reps,
                                    device))
            _write(path, rows)  # checkpoint after every rung
        print(f"[perf] {name} done in {time.time() - t0:.0f}s", flush=True)
    return rows


def section_eightk(out_dir, device) -> None:
    """The 8K turbo rung (reference README.md:26, atomic 716 ms at
    7680x4320 on the 1080 Ti), 3 reps, in this process."""
    path = os.path.join(out_dir, "perf.jsonl")
    rows = _load(path)
    if any(r.get("algorithm") == "turbo" and r.get("height") == EIGHTK[0]
           and "error" not in r for r in rows):
        print("[8k] already measured - skip", flush=True)
        return
    rows.extend(ladder_rows("turbo", [EIGHTK], {}, "blobs", 3, device))
    _write(path, rows)


@contextlib.contextmanager
def _fallbacks():
    """Counts the runs of the atomic path while open: a checked entry's
    "fallback" overflow policy routes there."""
    from ..models import atomic_boruvka

    count = [0]
    atomic = atomic_boruvka.segment_atomic

    def counted(*args, **kwargs):
        count[0] += 1
        return atomic(*args, **kwargs)

    atomic_boruvka.segment_atomic = counted
    try:
        yield count
    finally:
        atomic_boruvka.segment_atomic = atomic


def section_quality(device, n=20, algos=QUALITY_ALGOS) -> list:
    """The synthetic set at its design point (k 30, min_size 10: 6 blobs,
    noise 10 at 161x241). on_overflow "fallback" routes a flagged run to
    the atomic path, which gives the same partition; `fallback` records
    it (never for the atomic path itself), `ms` the host milliseconds of
    the call up to its labels on the host."""
    from .. import _image_on
    from ..metrics.compare import asa_ue_best_gt
    from ..utils.datasets import synthetic_quality_set
    from ..utils.labels import compact_labels_np

    rows = []
    samples = list(synthetic_quality_set(n=n))
    images = [_image_on(image, device) for _, image, _ in samples]
    card = harness.card(device)
    for name, extra in algos:
        cfg = SegmentationConfig(k=30.0, min_size=10,
                                 on_overflow="fallback", **extra)
        fn = harness.segment_fn(base_algo(name), cfg, device=device)
        t0 = time.time()
        for (iname, _, gts), image in zip(samples, images):
            try:
                with _fallbacks() as fell:
                    t1 = time.perf_counter()
                    labels = fn(image).cpu().numpy()
                    ms = (time.perf_counter() - t1) * 1e3
            except Exception as e:  # the row records it
                rows.append({"image": iname, "algorithm": name, "card": card,
                             "error": str(e).splitlines()[0][:300]})
                print(f"[quality] {name}@{iname} FAILED", flush=True)
                continue
            asa, ue = asa_ue_best_gt(compact_labels_np(labels), gts)
            rows.append({"image": iname, "algorithm": name, "asa": asa,
                         "ue": ue, "card": card, "ms": ms,
                         "fallback": bool(fell[0]) and name != "atomic"})
        scored = [r["asa"] for r in rows
                  if r["algorithm"] == name and "asa" in r]
        print(f"[quality] {name}: ASA median {np.median(scored):.4f} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return rows


def section_bsds_quality(device, root=None, n=20) -> list:
    """The reference's quality protocol (Report §4.2): K 80, min_size 100,
    hierarchy level 4 for the hierarchy algorithms (quality mode on its
    final map, whose levels do not match the reference's level semantics),
    the best of each image's ground truths; on BSDS500 where `root` holds
    it, else on the bsds_like stand-in."""
    from .. import _image_on
    from ..metrics.compare import asa_ue_best_gt
    from ..utils import datasets
    from ..utils.labels import compact_labels_np

    if datasets.bsds500_available(root):
        samples = list(datasets.load_bsds500(root, split="val"))
        source = "bsds500"
    else:
        samples = list(datasets.bsds_like_quality_set(n=n))
        source = "bsds_like"
    card = harness.card(device)
    backend = torch.device(device).type
    rows = []
    for name, extra in QUALITY_ALGOS:
        cfg = SegmentationConfig(k=80.0, min_size=100,
                                 on_overflow="fallback", **extra)
        level = "final" if extra.get("weight_buckets") else 4
        fn = (harness.segment_fn(base_algo(name), cfg, device=device)
              if level == "final" else
              harness.segment_level_fn(base_algo(name), cfg, level=4,
                                       device=device))
        t0 = time.time()
        for iname, image, gts in samples:
            try:
                labels = fn(_image_on(image, device)).cpu().numpy()
            except Exception as e:  # the row records it
                rows.append({"image": iname, "algorithm": name,
                             "source": source, "card": card,
                             "error": str(e).splitlines()[0][:300]})
                print(f"[bsds] {name}@{iname} FAILED", flush=True)
                continue
            asa, ue = asa_ue_best_gt(compact_labels_np(labels), gts)
            rows.append({"image": iname, "algorithm": name,
                         "source": source, "level": level,
                         "backend": backend, "card": card, "asa": asa,
                         "ue": ue})
        scored = [r["asa"] for r in rows
                  if r["algorithm"] == name and "asa" in r]
        if scored:
            print(f"[bsds] {name}: ASA median {np.median(scored):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return rows


BATCHES = (((1080, 1920), 4), ((2160, 3840), 2))


def section_batch(device) -> list:
    """Batched turbo (the serving-throughput row; the reference segments
    one image at a time): seeds 0..batch-1 of the ladder's blobs, 3 reps
    of `_timed`."""
    from .. import _image_on
    from ..parallel.batching import segment_batch_flagged
    from ..utils.synthetic import blobs_image

    cfg = SegmentationConfig(k=300.0, min_size=100, algorithm="turbo")
    card = harness.card(device)
    rows = []
    for (h, w), bs in BATCHES:
        print(f"[batch] {h}x{w} x{bs}", flush=True)
        try:
            imgs = _image_on(np.stack([
                blobs_image(h, w, num_blobs=max(8, (h * w) // 65536),
                            seed=s) for s in range(bs)]), device)
            flags = segment_batch_flagged(imgs, cfg, device)[1]
            st = harness._timed(
                lambda: segment_batch_flagged(imgs, cfg, device)[0], reps=3)
            rows.append({
                "height": h, "width": w, "batch": bs, "total": st,
                "flags": flags, "card": card,
                "mpix_per_s": bs * h * w / 1e6 / st["mean_s"],
                "mpix_per_s_median": bs * h * w / 1e6 / st["median_s"]})
            print(f"[batch] {h}x{w} x{bs}: median "
                  f"{st['median_s'] * 1e3:.3f} ms, "
                  f"{rows[-1]['mpix_per_s_median']:.1f} MPix/s, flags "
                  f"{flags} ({card})", flush=True)
            del imgs
        except Exception as e:  # the row records it
            rows.append({"height": h, "width": w, "batch": bs, "card": card,
                         "error": str(e).splitlines()[0][:300]})
    return rows


def section_plots(out_dir) -> None:
    from . import plots
    from .__main__ import _figure

    perf_path = os.path.join(out_dir, "perf.jsonl")
    perf = [r for r in _load(perf_path)
            if "error" not in r and r.get("content", "blobs") == "blobs"]
    if perf:
        _figure(plots.plot_performance, perf,
                os.path.join(out_dir, "perf.png"), perf_path,
                reference=plots.REFERENCE_TOTALS)
    for stem, kwargs in (("quality", {}), ("bsds_quality", dict(
            reference=plots.REFERENCE_QUALITY_MEDIANS))):
        path = os.path.join(out_dir, f"{stem}.jsonl")
        rows = [r for r in _load(path) if "asa" in r]
        if rows:
            _figure(plots.plot_quality, rows,
                    os.path.join(out_dir, f"{stem}.png"), path, **kwargs)
            _figure(plots.plot_quality_cdf, rows,
                    os.path.join(out_dir, f"{stem}_cdf.png"), path)
    print("[plots] done", flush=True)


def main(argv=None) -> int:
    from .. import _device
    from . import fig3

    ap = argparse.ArgumentParser(prog="gseg_tpu_torch.bench.evidence")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; raises without a "
                         "CUDA device unless this is 'cpu')")
    ap.add_argument("--quality-n", type=int, default=20,
                    help="images of the synthetic and bsds_like sets")
    ap.add_argument("--bsds-root", default=os.environ.get("GSEG_BSDS_ROOT"))
    args = ap.parse_args(argv)
    sections = args.sections.split(",")
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"unknown sections {sorted(unknown)}")
    device = _device(args.device)
    out = args.out
    os.makedirs(out, exist_ok=True)

    if "perf" in sections:
        section_perf(out, device)
    if "eightk" in sections:
        section_eightk(out, device)
    fig3_path = os.path.join(out, "fig3.jsonl")
    if "fig3" in sections and (args.force or not _done(fig3_path)):
        print("[fig3] running", flush=True)
        fig3.main(["--reps", "100", "--out", fig3_path, "--device",
                   str(device)])
    for section, fname, run in (
            ("quality", "quality.jsonl",
             lambda: section_quality(device, args.quality_n)),
            ("bsds", "bsds_quality.jsonl",
             lambda: section_bsds_quality(device, args.bsds_root,
                                          args.quality_n)),
            ("batch", "batch.jsonl", lambda: section_batch(device))):
        path = os.path.join(out, fname)
        if section in sections and (args.force or not _done(path)):
            _write(path, run())
    if "plots" in sections:
        section_plots(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The hardware parity protocol: the turbo path's partitions against the
NumPy oracle, exactly (port of `scripts/check_tpu_parity.py`).

The standard check after a change to the kernels (`csrc/`,
`ops/kernels/`) or to the turbo path's hot loops. Clean flags cannot
catch a leaked minimum label (the reference's round-3 lesson: its strip
kernels once returned stable, wrong partitions with every flag 0); only
a comparison with the oracle can. It runs on the card (cuda:0; --device
cpu asks for the CPU, and without a card and without --device it raises):

  1. the 20-seed synthetic quality sweep (`synthetic_quality_set`, 161x241,
     k 30, min_size 10; the strongest detector: it found the reference's
     wrap bug on every seed), each partition equal to `segment_boruvka_np`
     computed on the host;
  2. 540p at the bench configuration (k 300, min_size 100) on blobs and on
     textured content, against the host oracle too;
  3. a row the reference lacks: textured 1080p at k 10, min_size 10 and
     `weight_buckets=16`, against its committed oracle
     (`oracles/textured_1080x1920_k10_wb16.npz`, 162 components). At the
     bench configuration textured content segments into one component
     (540p, 1080p and 4K), so row 2's textured check cannot fail on a
     leaked label; this one can.

Every row must give flags 0 and the oracle's canonical partition. One line
per row, as the reference prints them; any failure exits non-zero.

Usage: python -m gseg_tpu_torch.bench.parity [--seeds 20] [--skip-540p]
       [--device cuda:0|cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, NamedTuple

import numpy as np

from ..config import SegmentationConfig
from ..models.boruvka_cpu import segment_boruvka_np
from ..models.turbo import segment_turbo_flagged
from ..oracles import ORACLES, load_oracle, oracle_path, oracle_recipe
from ..utils.datasets import synthetic_quality_set
from ..utils.labels import canonical_min_labels_np
from .harness import ladder_image

SWEEP_CFG = SegmentationConfig(k=30.0, min_size=10)
BENCH_CFG = SegmentationConfig(k=300.0, min_size=100)
TEXTURED_ORACLE = "textured_1080x1920_k10_wb16"
GOSSIP_ROUNDS = 2


class Case(NamedTuple):
    name: str
    image: np.ndarray                 # (H, W, 3) uint8
    cfg: SegmentationConfig
    oracle: Callable[[], np.ndarray]  # its labels, any ids


def _host_oracle(image, cfg):
    return lambda: segment_boruvka_np(image, cfg)


def cases(seeds: int = 20, skip_540p: bool = False) -> list[Case]:
    """The protocol's rows, in order."""
    out = [Case(name, image, SWEEP_CFG, _host_oracle(image, SWEEP_CFG))
           for name, image, _ in synthetic_quality_set(n=seeds)]
    if skip_540p:
        return out
    # the reference's images: blobs_image(540, 960, 8, 8.0, 0) and
    # textured_image(540, 960, 0)
    for content in ("blobs", "textured"):
        image = ladder_image(540, 960, content)
        out.append(Case(f"540p {content}", image, BENCH_CFG,
                        _host_oracle(image, BENCH_CFG)))
    h, w, _ = ORACLES[TEXTURED_ORACLE]
    content, cfg = oracle_recipe(TEXTURED_ORACLE)
    out.append(Case("1080p textured k10 wb16", ladder_image(h, w, content),
                    cfg, lambda: load_oracle(oracle_path(TEXTURED_ORACLE))))
    return out


def check(case: Case, device) -> dict:
    """One row on `device`: the turbo path's flags, and whether its
    partition is the oracle's (with the count of pixels off it)."""
    from .. import _image_on

    labels, flags = segment_turbo_flagged(_image_on(case.image, device),
                                          case.cfg, GOSSIP_ROUNDS)
    got = canonical_min_labels_np(labels.cpu().numpy())
    want = canonical_min_labels_np(case.oracle())
    ndiff = int((got != want).sum())
    return {"name": case.name, "flags": int(flags), "equal": ndiff == 0,
            "pixels_differ": ndiff, "components": int(np.unique(got).size)}


def main(argv=None) -> None:
    from .. import _device

    ap = argparse.ArgumentParser(prog="gseg_tpu_torch.bench.parity")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--skip-540p", action="store_true",
                    help="only the synthetic sweep")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; raises without a "
                         "CUDA device unless this is 'cpu')")
    args = ap.parse_args(argv)
    device = _device(args.device)
    bad = 0
    for case in cases(args.seeds, args.skip_540p):
        row = check(case, device)
        print(f"{row['name']}: flags={row['flags']} equal={row['equal']}",
              flush=True)
        bad += not row["equal"] or row["flags"] != 0
    if bad:
        raise SystemExit(f"PARITY FAILURES: {bad}")
    print("ALL PARITY CHECKS PASSED", flush=True)


if __name__ == "__main__":
    main()

"""Dataset loaders (port of `gseg_tpu.utils.datasets`): the BSDS500 quality
set and its synthetic stand-ins.

The reference benchmarks quality on BSDS500 (481x321 JPGs with several
human ground-truth segmentations each; reference README.md:21, Report.pdf
p.5 §4.2). The dataset is not bundled: `load_bsds500` reads the standard
layout if present (images/<split>/*.jpg and groundTruth/<split>/*.mat,
with scipy), and `bsds_like_quality_set` / `synthetic_quality_set` give
deterministic stand-ins with known ground truth, byte-equal to the
reference's.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Tuple

import numpy as np

from .synthetic import blobs_ground_truth, blobs_image, bsds_like_scene

Sample = Tuple[str, np.ndarray, List[np.ndarray]]


def load_bsds500(root: str, split: str = "val", limit: int | None = None
                 ) -> Iterator[Sample]:
    """Yields (name, image, [gt label maps]) from a BSDS500 tree.

    Expects <root>/images/<split>/*.jpg and <root>/groundTruth/<split>/*.mat
    (the official layout). Each .mat holds several human segmentations;
    all are returned, and the scorer picks the ASA-maximizing one
    (reference protocol, report-extract 608-611).
    """
    import scipy.io

    from . import image_io

    img_dir = os.path.join(root, "images", split)
    gt_dir = os.path.join(root, "groundTruth", split)
    paths = sorted(glob.glob(os.path.join(img_dir, "*.jpg")))
    if limit:
        paths = paths[:limit]
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0]
        gt_path = os.path.join(gt_dir, name + ".mat")
        if not os.path.exists(gt_path):
            continue
        image = image_io.read_image(p)
        mat = scipy.io.loadmat(gt_path)
        gts = [
            np.asarray(entry["Segmentation"][0, 0], dtype=np.int32)
            for entry in mat["groundTruth"][0]
        ]
        yield name, image, gts


def bsds500_available(root: str | None) -> bool:
    return bool(root) and os.path.isdir(os.path.join(root, "images"))


def bsds_like_quality_set(n: int = 20, h: int = 321, w: int = 481,
                          seed0: int = 0) -> Iterator[Sample]:
    """BSDS500-protocol stand-in: 481x321 photo-like scenes, each with
    several pseudo-ground-truths at annotator-like granularities
    (`synthetic.bsds_like_scene`). Same (name, image, gts) interface as
    load_bsds500, so the reference's scoring (K=80, hierarchy level 4,
    ASA-maximizing GT; report-extract.txt:651-658, 608-611) runs unchanged
    without the dataset."""
    for seed in range(seed0, seed0 + n):
        img, gts = bsds_like_scene(h, w, seed=seed)
        yield f"bsdslike{seed:03d}", img, gts


def synthetic_quality_set(n: int = 20, h: int = 161, w: int = 241,
                          noise: float = 10.0) -> Iterator[Sample]:
    """Deterministic blob images with exact ground truth (same (name,
    image, gts) interface)."""
    for seed in range(n):
        img = blobs_image(h, w, num_blobs=6, noise=noise, seed=seed)
        gt = blobs_ground_truth(h, w, num_blobs=6, seed=seed)
        yield f"synthetic{seed:03d}", img, [gt]

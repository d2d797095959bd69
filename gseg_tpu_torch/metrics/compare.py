"""ASA / UE quality metrics (port of `gseg_tpu.metrics.compare`, the
reference's `comparetool`).

The reference scores segmentations against BSDS500 human ground truths
(Report.pdf p.5-6 §4.2, Eqs. 1-2):

    ASA(S) = sum_k max_i |s_k ∩ g_i|                / sum_i |g_i|
    UE(S)  = sum_i sum_{k: s_k∩g_i≠∅} min(|s_k ∩ g_i|, |s_k - g_i|) / sum_i |g_i|

where s_k are segmentation components and g_i ground-truth segments; both
denominators equal the pixel count. With several ground truths, the one
maximizing ASA is used (report-extract.txt:608-611).

`asa_ue` and `asa_ue_best_gt` are NumPy on the host (a sparse overlap
histogram from np.unique on paired codes), as in the reference;
`asa_ue_torch` builds a dense histogram on the labels' device; the C++
comparetool is `native.bindings.asa_ue_native`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _overlap_counts(seg: np.ndarray, gt: np.ndarray):
    """Sparse |s_k ∩ g_i| table: returns (seg_ids, gt_ids, counts) and the
    per-seg-component total sizes aligned to seg_ids."""
    seg = np.asarray(seg).ravel()
    gt = np.asarray(gt).ravel()
    _, seg_c = np.unique(seg, return_inverse=True)
    _, gt_c = np.unique(gt, return_inverse=True)
    n_gt = int(gt_c.max()) + 1
    code = seg_c.astype(np.int64) * n_gt + gt_c
    pair, cnt = np.unique(code, return_counts=True)
    sk = pair // n_gt
    gi = pair % n_gt
    seg_sizes = np.bincount(seg_c)
    return sk, gi, cnt, seg_sizes


def asa_ue(seg: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """ASA and UE of a segmentation vs one ground-truth label map."""
    sk, gi, cnt, seg_sizes = _overlap_counts(seg, gt)
    n = seg.size
    # ASA: per seg component, its largest overlap with any gt segment.
    best = np.zeros(seg_sizes.shape[0], dtype=np.int64)
    np.maximum.at(best, sk, cnt)
    asa = best.sum() / n
    # UE: per overlapping (s_k, g_i): min(|s_k ∩ g_i|, |s_k| - |s_k ∩ g_i|).
    ue = np.minimum(cnt, seg_sizes[sk] - cnt).sum() / n
    return float(asa), float(ue)


def asa_ue_best_gt(seg: np.ndarray, gts: Sequence[np.ndarray]
                   ) -> Tuple[float, float]:
    """Score against the ground truth maximizing ASA (reference protocol;
    on a tie the first such ground truth is kept)."""
    best = (-1.0, 0.0)
    for gt in gts:
        a, u = asa_ue(seg, gt)
        if a > best[0]:
            best = (a, u)
    return best


def asa_ue_torch(seg: torch.Tensor, gt: torch.Tensor, num_seg: int,
                 num_gt: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """ASA and UE on the labels' device from a dense (num_seg, num_gt)
    overlap histogram; the port of the reference's `asa_ue_jax`.

    seg/gt: (H, W) int labels already compacted to [0, num_seg) and
    [0, num_gt), on one device. A pair code outside the table is dropped,
    as the reference's scatter with mode="drop" drops it. Returns two
    float64 0-d tensors: integer sums over the pixel count, so they equal
    `asa_ue`'s floats exactly (the reference's float32 within 1e-6).
    """
    seg = seg.reshape(-1).long()
    gt = gt.reshape(-1).long()
    n = seg.numel()
    code = seg * num_gt + gt
    inside = (code >= 0) & (code < num_seg * num_gt)
    hist = torch.zeros(num_seg * num_gt, dtype=torch.int64,
                       device=seg.device).index_add_(
        0, torch.where(inside, code, 0), inside.long())
    hist = hist.reshape(num_seg, num_gt)
    seg_sizes = hist.sum(dim=1, keepdim=True)
    # a divisor on the device: torch's CUDA division by a host scalar
    # multiplies by its reciprocal, one rounding more than NumPy's a / n
    count = torch.full((), n, dtype=torch.float64, device=seg.device)
    asa = hist.max(dim=1).values.sum().double() / count
    ue = torch.minimum(hist, seg_sizes - hist).sum().double() / count
    return asa, ue

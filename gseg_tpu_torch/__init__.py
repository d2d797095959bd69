"""gseg_tpu_torch — the PyTorch/CUDA port of `gseg_tpu`.

A second package beside the JAX reference, for NVIDIA Hopper (H100). It
imports torch and never jax. It ports the turbo path, in speed mode
(`weight_buckets=0`) and in quality mode (`weight_buckets > 0`, the
weight-quantile bucket ramp): smoothing and edge weights, the stage-G
gossip rounds, the boundary-edge handoff, the stage-2 compact rounds and
the final map, with hand-written CUDA kernels (built from `csrc/` on first
use) for the step fixpoints, the scan closures, the boundary extraction,
the row-run extraction and the wide-image padding. The NumPy Boruvka
oracle is ported (`models.boruvka_cpu`, with committed oracle partitions
in `oracles/`), but `segment()` does not dispatch to it; the atomic,
fastmst and superpixel algorithms are not ported yet.

Public API:
    segment(image, sigma=.8, k=300, min_size=100, algorithm="turbo",
            device=None) -> (H, W) int32 label tensor, on cuda:0 unless
            device="cpu" is given
    SegmentationConfig
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ALGORITHMS, SegmentationConfig

__all__ = ["ALGORITHMS", "SegmentationConfig", "segment"]


def segment(image, sigma=0.8, k=300.0, min_size=100, algorithm="turbo",
            config: SegmentationConfig | None = None, device=None):
    """Segment an (H, W, 3) image (NumPy array or tensor); returns (H, W)
    int32 canonical labels (min member pixel id) on `device`. Quality
    mode: pass a `config` with `weight_buckets > 0` (16 is the reference's
    quality setting).

    device: default cuda:0, whatever device the image is on; without a
    CUDA device this raises RuntimeError. Pass device="cpu" to run on the
    CPU (the kernels' plain PyTorch versions)."""
    from .models import turbo

    cfg = config or SegmentationConfig(
        sigma=sigma, k=k, min_size=min_size, algorithm=algorithm)
    if cfg.algorithm != "turbo":
        raise NotImplementedError(
            f"algorithm {cfg.algorithm!r} is not ported yet (ROADMAP.md, "
            "queue 1, items 9-10)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gseg_tpu_torch.segment runs on the GPU by default and no "
                "CUDA device is available; pass device=\"cpu\" to run on "
                "the CPU")
        device = torch.device("cuda", 0)
    if not isinstance(image, torch.Tensor):
        image = torch.as_tensor(np.asarray(image))
    return turbo.segment_turbo(image.to(device), cfg)

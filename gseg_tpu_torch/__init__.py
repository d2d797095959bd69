"""gseg_tpu_torch — the PyTorch/CUDA port of `gseg_tpu`.

A second package beside the JAX reference, for NVIDIA Hopper (H100). It
imports torch and never jax. This slice ports the turbo path in speed mode
(`weight_buckets=0`): smoothing and edge weights, the stage-G gossip
rounds, the boundary-edge handoff, the stage-2 compact rounds and the final
map, with hand-written CUDA kernels (built from `csrc/` on first use) for
the step fixpoints and the boundary extraction.

Public API:
    segment(image, sigma=.8, k=300, min_size=100, algorithm="turbo",
            device=None) -> (H, W) int32 label tensor
    SegmentationConfig
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ALGORITHMS, SegmentationConfig

__all__ = ["ALGORITHMS", "SegmentationConfig", "segment"]


def segment(image, sigma=0.8, k=300.0, min_size=100, algorithm="turbo",
            config: SegmentationConfig | None = None, device=None):
    """Segment an (H, W, 3) image; returns (H, W) int32 canonical labels
    (min member pixel id) on `device` (default: the image tensor's device,
    or the CPU for a NumPy image)."""
    cfg = config or SegmentationConfig(
        sigma=sigma, k=k, min_size=min_size, algorithm=algorithm)
    if cfg.algorithm != "turbo":
        raise NotImplementedError(
            f"algorithm {cfg.algorithm!r} is not ported yet (ROADMAP.md, "
            "queue 1, items 9-10)")
    if isinstance(image, torch.Tensor):
        image = image.to(device) if device is not None else image
    else:
        image = torch.as_tensor(np.asarray(image), device=device)
    from .models.turbo import segment_turbo

    return segment_turbo(image, cfg)

"""gseg_tpu_torch — the PyTorch/CUDA port of `gseg_tpu`.

A second package beside the JAX reference, for NVIDIA Hopper (H100). It
imports torch and never jax. It ports:

  - the turbo path, in speed mode (`weight_buckets=0`) and in quality mode
    (`weight_buckets > 0`, the weight-quantile bucket ramp): smoothing and
    edge weights, the stage-G gossip rounds, the boundary-edge handoff, the
    stage-2 compact rounds and the final map, with hand-written CUDA
    kernels (built from `csrc/` on first use) for the step fixpoints, the
    scan closures, the boundary extraction, the row-run extraction and the
    wide-image padding; and its hierarchy (`segment_hierarchy`);
  - the atomic path (`models.atomic_boruvka`: scatter-min Boruvka rounds in
    plain torch ops on the device, as in the reference, which has no Pallas
    kernel there), with its hierarchy;
  - the fastmst (DPP) path (`models.fastmst`: a dense round 1, chunked
    pair extraction, the compact rounds in plain torch ops) and the
    superpixel hierarchy (`models.superpixel`: the same schedule with the
    weights recomputed every round from colour sums, which a hand-written
    CUDA helper adds in the reference's order), both with their
    hierarchies, their maps rendered by the step kernel's value flood;
  - the NumPy oracles `models.boruvka_cpu`, `models.felzenszwalb_cpu` and
    `models.fastmst_np` (committed oracle data in `oracles/`), and the C++
    Felzenszwalb baseline `kruskal_native` (`native/`, built with g++ on
    first use);
  - the user surface: the CLI (`python -m gseg_tpu_torch`, `cli.py`),
    image I/O, `colorize`, the ASA/UE metrics (`metrics.compare`), the
    quality datasets (`utils.datasets`) and the quality benchmark
    (`python -m gseg_tpu_torch.bench quality`);
  - batching and multi-device (`parallel`): `segment_batch`,
    `segment_batch_sharded` over a `data_parallel_mesh`, the row-sharded
    atomic path (`segment_spatial` over a `spatial_mesh`,
    `multichip_step` over a data x space mesh) and the row-sharded turbo
    path (`segment_turbo_spatial`, its fixpoints on the step kernel over
    each rank's rows with exchanged halos). A mesh is a list of devices
    driven by one process, one thread per rank; a device may repeat.

Public API:
    segment(image, sigma=.8, k=300, min_size=100, algorithm="atomic",
            device=None) -> (H, W) int32 label tensor
    segment_hierarchy(...) -> (levels (L, H, W), labels (H, W))
    SegmentationConfig, colorize, colorize_hierarchy, compact_labels_np
Both run on cuda:0 unless device="cpu" is given. The default algorithm is
"atomic", as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ALGORITHMS, SegmentationConfig
from .utils import timing
from .utils.labels import colorize, colorize_hierarchy, compact_labels_np

__version__ = "0.1.0"

__all__ = [
    "ALGORITHMS",
    "SegmentationConfig",
    "segment",
    "segment_hierarchy",
    "colorize",
    "colorize_hierarchy",
    "compact_labels_np",
    "__version__",
]

# Paths that honor cfg.weight_buckets (the quality-mode bucket ramp); every
# other algorithm would silently ignore it.
_BUCKET_AWARE = ("turbo", "boruvka_cpu")


def _check_weight_buckets(cfg: SegmentationConfig, route: str) -> None:
    # the Kruskal paths already take the edges in sorted weight order, so
    # the ramp changes nothing there.
    kruskal = ("kruskal_cpu", "kruskal_native")
    if cfg.weight_buckets > 0 and route not in _BUCKET_AWARE + kruskal:
        raise ValueError(
            f"weight_buckets={cfg.weight_buckets} is only honored by "
            f"{_BUCKET_AWARE}; the {route!r} path would silently ignore it "
            "and produce a different partition. Use weight_buckets=0 or "
            "algorithm='turbo'."
        )


def _config(config, **kw) -> SegmentationConfig:
    cfg = config or SegmentationConfig(**kw)
    _check_weight_buckets(cfg, cfg.algorithm)
    return cfg


def _device(device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gseg_tpu_torch runs on the GPU by default and no CUDA device "
            "is available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)


def _image_on(image, device) -> torch.Tensor:
    if not isinstance(image, torch.Tensor):
        image = torch.as_tensor(np.asarray(image))
    return image.to(device)


def _host_image(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        return image.cpu().numpy()
    return np.asarray(image)


def segment(image, sigma=0.8, k=300.0, min_size=100, algorithm="atomic",
            config: SegmentationConfig | None = None, device=None):
    """Segment an (H, W, 3) image (NumPy array or tensor); returns (H, W)
    int32 labels on `device`: canonical min-pixel ids on the turbo route,
    root vertex ids on the others, as in the reference (compare partitions
    with `utils.labels.canonical_min_labels_np`). Quality mode: pass a
    `config` with `weight_buckets > 0` (turbo and boruvka_cpu only).

    device: default cuda:0, whatever device the image is on; without a
    CUDA device this raises RuntimeError. Pass device="cpu" to run on the
    CPU (the kernels' plain PyTorch versions). The boruvka_cpu and
    kruskal_cpu oracles and the kruskal_native C++ baseline run on the
    host and return their labels on `device`. The superpixel route
    returns one level of its hierarchy (cfg.hierarchy_levels, default
    4). With the tracing on (`utils.timing`) the call is the span
    gseg.segment, a frame of its own."""
    cfg = _config(config, sigma=sigma, k=k, min_size=min_size,
                  algorithm=algorithm)
    h, w = np.shape(image)[:2]
    with timing.span("gseg.segment", algorithm=cfg.algorithm, h=h, w=w):
        return _segment(image, cfg, _device(device))


def _segment(image, cfg: SegmentationConfig, device):
    if cfg.algorithm == "turbo":
        from .models.turbo import segment_turbo

        return segment_turbo(_image_on(image, device), cfg)
    if cfg.algorithm in ("atomic", "atomic_hostsync"):
        from .models import atomic_boruvka

        fn = (atomic_boruvka.segment_atomic if cfg.algorithm == "atomic"
              else atomic_boruvka.segment_atomic_hostsync)
        return fn(_image_on(image, device), cfg)
    if cfg.algorithm == "fastmst":
        from .models.fastmst import segment_fastmst

        return segment_fastmst(_image_on(image, device), cfg)
    if cfg.algorithm == "superpixel":
        from .models.superpixel import segment_superpixel

        return segment_superpixel(_image_on(image, device), cfg)
    if cfg.algorithm == "boruvka_cpu":
        from .models.boruvka_cpu import segment_boruvka_np

        labels = segment_boruvka_np(_host_image(image), cfg)
    elif cfg.algorithm == "kruskal_cpu":
        from .models.felzenszwalb_cpu import segment_kruskal_np

        labels = segment_kruskal_np(_host_image(image), cfg)
    elif cfg.algorithm == "kruskal_native":
        from .native.bindings import segment_kruskal_native

        labels = segment_kruskal_native(_host_image(image), cfg)
    else:
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}")
    return torch.from_numpy(labels).to(device)


def segment_hierarchy(image, sigma=0.8, k=300.0, min_size=100,
                      algorithm="atomic",
                      config: SegmentationConfig | None = None, device=None):
    """Segment and return the per-round hierarchy: (levels, labels),
    levels (L, H, W) int32 one label map per Boruvka round (the
    reference's segmentation-hierarchy output), labels (H, W) the final
    map after the min-size rounds, both on `device` (as `segment`)."""
    cfg = _config(config, sigma=sigma, k=k, min_size=min_size,
                  algorithm=algorithm)
    device = _device(device)
    if cfg.algorithm == "turbo":
        from .models.turbo import segment_turbo_hierarchy

        return segment_turbo_hierarchy(_image_on(image, device), cfg)
    if cfg.algorithm in ("atomic", "atomic_hostsync"):
        from .models.atomic_boruvka import segment_atomic_hierarchy

        return segment_atomic_hierarchy(_image_on(image, device), cfg)
    if cfg.algorithm == "fastmst":
        from .models.fastmst import segment_fastmst_hierarchy

        return segment_fastmst_hierarchy(_image_on(image, device), cfg)
    if cfg.algorithm == "superpixel":
        from .models.superpixel import segment_superpixel_hierarchy

        return segment_superpixel_hierarchy(_image_on(image, device), cfg)
    if cfg.algorithm == "boruvka_cpu":
        from .models.boruvka_cpu import segment_boruvka_np

        labels, levels = segment_boruvka_np(_host_image(image), cfg,
                                            return_levels=True)
        return (torch.from_numpy(levels).to(device),
                torch.from_numpy(labels).to(device))
    raise ValueError(f"no hierarchy mode for algorithm {cfg.algorithm!r}")

"""Batches of images, optionally split over the devices of a mesh (port of
`gseg_tpu/parallel/batching.py`).

The reference vmaps the atomic path and `lax.map`s the compact-round paths
(turbo, fastmst, superpixel) over the batch. Their loops depend on the
data, so there is no `torch.vmap` here: every path segments the images one
after another, each with its own loop counts, as `lax.map` runs them. The
data-parallel form (`segment_batch_sharded`) gives each rank of a 1-D mesh
a contiguous share of the batch; each image stays on its rank's device and
no data crosses between ranks but the flags.
"""

from __future__ import annotations

import torch

from .. import _device, _image_on
from ..config import SegmentationConfig
from ..models.turbo import describe_flags
from .mesh import Mesh, as_tensor, axis_devices, default_devices, run_ranks


def _segment_one(image, cfg: SegmentationConfig):
    """(labels, flags) of one image on the path cfg.algorithm names."""
    if cfg.algorithm == "atomic":
        from ..models.atomic_boruvka import segment_atomic_impl

        return segment_atomic_impl(image, cfg), 0
    if cfg.algorithm == "turbo":
        from ..models.turbo import segment_turbo_impl as fn
    elif cfg.algorithm == "fastmst":
        from ..models.fastmst import segment_fastmst_impl as fn
    elif cfg.algorithm == "superpixel":
        from ..models.superpixel import segment_superpixel_impl as fn
    else:
        raise ValueError(f"no batched form of algorithm {cfg.algorithm!r}")
    return fn(image, cfg)


def segment_batch_flagged(images, cfg: SegmentationConfig, device=None):
    """(B, H, W, 3) -> (labels (B, H, W) int32 on `device`, int flags ORed
    over the batch). device: as in `gseg_tpu_torch.segment` (default
    cuda:0, whatever device the images are on; RuntimeError without a
    card; "cpu" only when asked)."""
    images = _image_on(images, _device(device))
    labels, flags = [], 0
    for im in images:
        lab, f = _segment_one(im, cfg)
        labels.append(lab)
        flags |= int(f)
    return torch.stack(labels), flags


def _atomic_batch(images, cfg: SegmentationConfig):
    from ..models.atomic_boruvka import segment_atomic_impl

    return torch.stack([segment_atomic_impl(im, cfg) for im in images])


def _checked(labels, flags, images, cfg: SegmentationConfig, what: str):
    """The batch's overflow policy: "fallback" re-runs the whole batch on
    the atomic path, "ignore" keeps the labels, "raise" raises."""
    if flags == 0 or cfg.on_overflow == "ignore":
        return labels
    if cfg.on_overflow == "fallback":
        return _atomic_batch(images, cfg)
    raise RuntimeError(f"turbo capacity/budget violation in {what}: "
                       + describe_flags(flags))


def segment_batch(images, cfg: SegmentationConfig,
                  device=None) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) int32 labels on `device` (as in
    `segment_batch_flagged`), checking the flags once per batch (see
    models.turbo.segment_turbo for the per-image meaning)."""
    images = _image_on(images, _device(device))
    labels, flags = segment_batch_flagged(images, cfg, images.device)
    return _checked(labels, flags, images, cfg, "batch")


def data_parallel_mesh(devices=None, axis: str = "data") -> Mesh:
    """A 1-D mesh over `devices` (default: every CUDA device; raises
    without one). `["cuda:0"] * 2` puts two ranks on one card."""
    return Mesh(default_devices() if devices is None else devices, (axis,))


def segment_batch_sharded(images, cfg: SegmentationConfig, mesh: Mesh,
                          axis: str = "data") -> list[torch.Tensor]:
    """Data-parallel batched segmentation: the (B, H, W, 3) batch is split
    in order over the ranks of `mesh`'s axis (B divisible by its size), and
    each rank segments its share on its device, one image after another.
    The flags are ORed over the whole batch and checked as in
    `segment_batch`: "fallback" re-runs each share on the atomic path.
    Returns one (B / n, H, W) int32 block of labels per rank, in order,
    each on its rank's device.

    The ranks take turns (`mesh._Group`) and meet only at the flags, so
    each holds the turn for its whole share: the shares run one after
    another, and n cards give about one card's throughput (PERF.md §6).
    This is the reference's sharded form, not a faster one."""
    images = as_tensor(images)
    devices = axis_devices(mesh, axis)
    n = len(devices)
    b = images.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} not divisible by mesh axis {axis!r} "
                         f"of size {n}")
    per = b // n
    shares = [images[i * per:(i + 1) * per].to(d)
              for i, d in enumerate(devices)]

    def run(rank, share):
        labels, flags = segment_batch_flagged(share, cfg, rank.device)
        flags = rank.or_flags(flags)
        return _checked(labels, flags, share, cfg, "sharded batch")

    return run_ranks(devices, run, shares)

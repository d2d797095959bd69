"""Label-map utilities (port of `gseg_tpu.utils.labels`): compaction and
canonical forms in NumPy, random colouring in torch on the labels' device.
"""

from __future__ import annotations

import numpy as np
import torch


def compact_labels_np(labels: np.ndarray) -> np.ndarray:
    """Relabel arbitrary int labels to consecutive ids [0, n)."""
    _, inv = np.unique(labels, return_inverse=True)
    return inv.reshape(labels.shape).astype(np.int32)


def num_components(labels) -> int:
    return int(np.unique(np.asarray(labels)).size)


def canonical_min_labels_np(labels: np.ndarray) -> np.ndarray:
    """Relabel each class by its minimum member vertex id (flat index).

    Two label maps describe the same segmentation iff their canonical forms
    are equal.
    """
    flat = np.asarray(labels).ravel()
    uniq, inv = np.unique(flat, return_inverse=True)
    minid = np.full(uniq.shape, np.iinfo(np.int64).max)
    np.minimum.at(minid, inv, np.arange(flat.size))
    return minid[inv].reshape(np.asarray(labels).shape).astype(np.int32)


def _colour_table(v: int, seed: int, device) -> torch.Tensor:
    """(v, 3) uint8 colours in [30, 256), drawn on the CPU from `seed` and
    moved once, so they are the same on every device."""
    gen = torch.Generator().manual_seed(seed)
    table = torch.randint(30, 256, (v, 3), generator=gen, dtype=torch.int32)
    return table.to(torch.uint8).to(device)


def colorize(labels: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """(H, W) int labels (root vertex ids in [0, H*W)) -> (H, W, 3) uint8
    on the labels' device.

    Colours are a function of (seed, component id), so one component keeps
    its colour on every hierarchy level. The table comes from a seeded
    `torch.Generator`, not `jax.random`: the colours differ from the
    reference's, the labels they paint do not.
    """
    h, w = labels.shape
    table = _colour_table(h * w, seed, labels.device)
    return table[labels.reshape(-1).long()].reshape(h, w, 3)


def colorize_hierarchy(levels: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """(L, H, W) labels -> (L, H, W, 3) uint8, one colour table for every
    level."""
    n, h, w = levels.shape
    table = _colour_table(h * w, seed, levels.device)
    return table[levels.reshape(-1).long()].reshape(n, h, w, 3)

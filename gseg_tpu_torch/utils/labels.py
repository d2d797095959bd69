"""Label-map utilities in NumPy (port of `gseg_tpu.utils.labels`)."""

from __future__ import annotations

import numpy as np


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

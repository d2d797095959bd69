"""The table of peaks and the byte counts of the rooflines.

Peaks are NVIDIA's published figures for one H100 SXM (data sheet, dense,
at the full 700 W); a card set below 700 W runs slower under load, so each
run prints the card's power limit beside its shares.

A fixpoint's least bytes: its read-only plane and every updated field
read once, every updated field written once, at 4 bytes a pixel of the
unpadded frame, whatever a kernel reads again. The count depends only on
the calls and their shapes, so it reads the same work whatever implements
the fixpoint, and fewer passes count as a gain."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100": {"hbm_bytes_per_s": 3.35e12,
                    "fp32_flops_per_s": 67e12},
}


def peak(kind: str, what: str) -> float:
    """The published peak `what` of a card whose name begins with one of
    PEAKS' keys ("NVIDIA H100 80GB HBM3" -> "NVIDIA H100")."""
    for name, table in PEAKS.items():
        if kind.startswith(name):
            return table[what]
    raise KeyError(f"no published peaks for {kind!r}")


def fixpoint_bytes(h: int, w: int, n_fields: int, word: int = 4) -> int:
    """Least bytes of one fixpoint call on an (h, w) frame with one
    read-only plane and `n_fields` updated fields."""
    return word * h * w * (1 + 2 * n_fields)

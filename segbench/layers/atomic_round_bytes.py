"""The least bytes of one atomic Boruvka round (`atomic_round_roofline`'s
count, kept with the benchmark): the four weight planes of the 8-connected
grid (E, S, SE, NE) read once, and the parent, size and Int planes each
read once and written once, at 4 bytes a pixel of the frame, whatever an
implementation reads again. The count depends only on the round and the
frame's shape, so it reads the same work whatever implements the round,
and fewer rounds count as a gain."""


def round_bytes(h: int, w: int) -> int:
    """Least bytes of one round on an (h, w) frame."""
    return 4 * h * w * (4 + 2 * 3)

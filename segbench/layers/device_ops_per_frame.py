"""device_ops_per_frame: kernels, copies and fills that ran on the card
in the traced window, over its frames. Layer: the device, the H100. Each
is a launch the host issued, so a count of the host's dispatch work that
does not drift with the host's speed: a gain in the host loop that
merges or drops launches shows here. Missing when the trace holds no
device activity."""


def instrument(tr) -> bool:
    return True


def read(tr):
    if tr.window is None or not tr.frames or tr.device.type != "cuda":
        return None
    lo, hi = tr.window
    n = sum(1 for _, s, e in tr.device_ops if e > lo and s < hi)
    return n / tr.frames if n else None

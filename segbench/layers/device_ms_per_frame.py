"""device_ms_per_frame: milliseconds a frame in which a kernel, copy or
fill ran on the card (the union of device activity over the traced
window, over its frames). Layer: the device, the H100. The card's work a
frame reads alike to about a percent from run to run, where the host's
speed, and with it the rate, drifts by tens of percent (PERF.md §2): a
gain in the kernels shows here first. Missing when the trace holds no
device activity."""


def instrument(tr) -> bool:
    return True


def read(tr):
    busy = tr.busy_s
    if busy is None or not tr.frames or tr.device.type != "cuda":
        return None
    return busy * 1e3 / tr.frames

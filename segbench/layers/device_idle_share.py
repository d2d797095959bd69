"""device_idle_share: the share of the traced window, in %, in which no
kernel, copy or fill ran on the card (1 minus the union of device activity
over the window's wall time). Layer: the device, the H100. Missing when
the trace holds no device activity."""


def read(tr):
    busy, window = tr.busy_s, tr.window_s
    if busy is None or not window or tr.device.type != "cuda":
        return None
    return 100.0 * (1.0 - busy / window)


def instrument(tr) -> bool:
    return True

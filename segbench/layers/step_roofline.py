"""step_roofline: the fixpoints' least time over their kernels' device
time, in %. Layer: the kernels, `ops/kernels/gossip.py` -> `csrc/gossip.cu`
(the step kernel) and `csrc/closure.cu` (the closures of the hybrid route,
which do part of the same fixpoints' work in quality mode).

The least time is `roofline.fixpoint_bytes` summed over the calls of
`gossip._fixpoint` in the window (wrapped from outside in the traced run,
which records each call's frame and fields) over the card's published HBM
bandwidth (`roofline.PEAKS`). The device time is that of the kernels
named `fixpoint_pass` (the step kernel), `closure_rows` and
`closure_cols` in the profiler's trace. Bound by bytes: the fixpoints do
no arithmetic worth a FLOP bound. Missing when `_fixpoint` is gone or no
such kernel ran."""

from segbench import roofline

KERNELS = r"fixpoint_pass|closure_rows|closure_cols"


def instrument(tr) -> bool:
    def make(fn):
        def recorded(variant, plain, ro, fields, *args, **kwargs):
            h, w = ro.shape
            tr.counters["fixpoint_bytes"] += roofline.fixpoint_bytes(
                h, w, len(fields))
            tr.counters["fixpoint_calls"] += 1
            return fn(variant, plain, ro, fields, *args, **kwargs)
        return recorded
    return tr.patch_module("gseg_tpu_torch.ops.kernels.gossip", "_fixpoint",
                           make)


def read(tr):
    device_s = tr.device_seconds(KERNELS)
    nbytes = tr.counters["fixpoint_bytes"]
    if not device_s or not nbytes or tr.device.type != "cuda":
        return None
    least_s = nbytes / roofline.peak(tr.kind, "hbm_bytes_per_s")
    return 100.0 * least_s / device_s

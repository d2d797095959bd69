"""atomic_round_roofline: the atomic rounds' least time over their time on
the card, in %. Layer: the atomic path, `models/atomic_boruvka.py`.

The least time is `atomic_round_bytes.round_bytes` summed over the calls
of `atomic_boruvka._round` in the window (wrapped from outside in the
traced run, which records each call's frame shape) over the card's
published HBM bandwidth (`roofline.PEAKS`). The time on the card is the
program's counter `device_ns.gseg.atomic_rounds` (see
`atomic_rounds_ms`). Bound by bytes: a round does no arithmetic worth a
FLOP bound. Missing when `_round` is gone, the program has no such
counter or the run had no card."""

from segbench import program, roofline
from segbench.layers.atomic_round_bytes import round_bytes

COUNTER = "device_ns.gseg.atomic_rounds"
BYTES = "atomic_round_bytes"


def instrument(tr) -> bool:
    def make(fn):
        def recorded(state, w8, eid8, shape, *args, **kwargs):
            tr.counters[BYTES] += round_bytes(*shape)
            return fn(state, w8, eid8, shape, *args, **kwargs)
        return recorded
    return (tr.patch_module("gseg_tpu_torch.models.atomic_boruvka",
                            "_round", make)
            and program.attach(tr))


def read(tr):
    ns = program.finish(tr).get(COUNTER)
    nbytes = tr.counters[BYTES]
    if not ns or not nbytes or tr.device.type != "cuda":
        return None
    least_s = nbytes / roofline.peak(tr.kind, "hbm_bytes_per_s")
    return 100.0 * least_s / (ns / 1e9)

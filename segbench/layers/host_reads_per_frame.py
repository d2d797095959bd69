"""host_reads_per_frame: reads of device tensors into host values (item,
bool, int, float, tolist) a frame, in the window of a traced run; each is
a wait for the card. Layer: the entry, `gseg_tpu_torch.segment` ->
`models/turbo.py:segment_turbo_impl`. A frozen copy of the host-read
counter of `chip_smoke.py` (`_host_reads`), installed from outside."""

import torch

METHODS = ("item", "__bool__", "__int__", "__float__", "tolist")


def instrument(tr) -> bool:
    def make(fn):
        def read(self, *args, **kwargs):
            if self.device.type == tr.device.type:
                tr.counters["host_reads"] += 1
            return fn(self, *args, **kwargs)
        return read
    return all([tr.patch(torch.Tensor, m, make) for m in METHODS])


def read(tr):
    if not tr.frames:
        return None
    return tr.counters["host_reads"] / tr.frames

"""atomic_rounds_ms: milliseconds a frame on the card inside the
program's span `gseg.atomic_rounds` (`models/atomic_boruvka.py`: every
felz round, then every min-size round, each ending in one read of its
merged flag), from the counter `device_ns.gseg.atomic_rounds`: the time
from the card reaching the span's first operation to its finishing the
last, between two CUDA events the program records at the span's ends,
so the card's waits for the host between rounds count too. Layer: the
atomic path, `models/atomic_boruvka.py`. Read from the program's own
tracing (`segbench/program.py`); missing when the program has no such
counter."""

from segbench import program

COUNTER = "device_ns.gseg.atomic_rounds"


def instrument(tr) -> bool:
    return program.attach(tr)


def read(tr):
    ns = program.finish(tr).get(COUNTER)
    return program.per_frame_ms(tr, None if ns is None else ns / 1e9)

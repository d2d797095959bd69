"""host_wait_ms: host milliseconds a frame spent in the program's reads of
device values (its `gseg.read.<site>` spans, summed over sites): how long
the host waited for the card. Layer: the entry, `gseg_tpu_torch.segment`
-> `models/turbo.py:segment_turbo_impl`. Read from the program's own
tracing (`segbench/program.py`); missing when the program has none."""

from segbench import program


def instrument(tr) -> bool:
    return program.attach(tr)


def read(tr):
    program.finish(tr)
    return program.per_frame_ms(tr, program.read_seconds(tr))

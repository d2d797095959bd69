"""dpp_extract_ms: milliseconds a frame on the card inside the program's
span `gseg.dpp_extract` (`_extract_compact`: the live boundary pairs of
the round-1 labels, deduplicated by chunked sorts into the compact pool
at 1.25 V), from the counter `device_ns.gseg.dpp_extract`: the time from
the card reaching the span's first operation to its finishing the last,
between two CUDA events the program records at the span's ends. The
host's time in the span would miss the work: the host leaves the span
once the work is queued, and the card does it later. Layer: the DPP
path, `models/fastmst.py`. Read from the program's own tracing
(`segbench/program.py`); missing when the program has no such counter."""

from segbench import program

COUNTER = "device_ns.gseg.dpp_extract"


def instrument(tr) -> bool:
    return program.attach(tr)


def read(tr):
    ns = program.finish(tr).get(COUNTER)
    return program.per_frame_ms(tr, None if ns is None else ns / 1e9)

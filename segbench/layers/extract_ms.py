"""extract_ms: host milliseconds a frame inside the program's span
`gseg.extract`, the handoff (`models/turbo.py:_extract_stage`: the
boundary-edge pool of `csrc/extract.cu`, then its sort-dedup into the
stage-2 pool). Layer: the stages. Read from the program's own tracing
(`segbench/program.py`); missing when the program has none."""

from segbench import program

SPAN = "gseg.extract"


def instrument(tr) -> bool:
    return program.attach(tr)


def read(tr):
    program.finish(tr)
    return program.per_frame_ms(tr, tr.span_seconds(SPAN))

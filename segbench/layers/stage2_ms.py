"""stage2_ms: host milliseconds a frame inside `models/turbo.py:_s2_stage`
(the compact Boruvka rounds on the handed-off edge pool, then the min-size
rounds), from a span the benchmark wraps around the module attribute in
the traced run. Layer: the stages. Missing when the attribute is gone."""

SPAN = "turbo._s2_stage"


def instrument(tr) -> bool:
    return tr.span("gseg_tpu_torch.models.turbo", "_s2_stage", SPAN)


def read(tr):
    s = tr.span_seconds(SPAN)
    if s is None or not tr.frames:
        return None
    return s * 1e3 / tr.frames

"""stage_g_ms: host milliseconds a frame inside `models/turbo.py:_stage_g`
(smoothing, edge weights and the stage-G gossip rounds), from a span the
benchmark wraps around the module attribute in the traced run. Layer: the
stages. Missing when the attribute is gone."""

SPAN = "turbo._stage_g"


def instrument(tr) -> bool:
    return tr.span("gseg_tpu_torch.models.turbo", "_stage_g", SPAN)


def read(tr):
    s = tr.span_seconds(SPAN)
    if s is None or not tr.frames:
        return None
    return s * 1e3 / tr.frames

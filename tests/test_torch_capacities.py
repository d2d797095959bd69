"""The turbo path's capacities follow the handoff gate, as the reference's
do.

`gseg_tpu` sizes the handoff's candidate pool, its pair pool and the
compact root list (`_extract_stage`, `_pools_to_state`), and stage 2's
recompact caps, live-count slice and main-phase root list (`_s2_stage`),
from the gate divisors GSEG_GATE_DIV (speed mode, default 128) and
GSEG_GATE_DIV_Q (quality mode, default 32). The port's gates are the
module attributes `turbo._GATE_DIV` / `_GATE_DIV_Q`, read at call time.

- `turbo.capacities` is held against the values the reference's own code
  passes to its pools, read by intercepting the calls that take them
  (the reference reads its variables at trace time: its jit caches are
  cleared around each run), at several V and gates.
- At 96x128 with the capacity floors shrunk in both packages (so the
  V-proportional capacities decide), early gates hand off many more
  components than the default: the port's labels and flags must be
  byte-equal to the reference's at gate 13 and 32 (speed mode) and
  gate_q 8 and 16 (quality mode), on one device and on 4 row-sharded
  ranks. Capacities fixed at the default gates raise FLAG_COMP_OVERFLOW
  and FLAG_PAIR_OVERFLOW (flags 6 or 14) there and return another
  partition, where the reference gives flags 0 (gate_q 8: its recompact
  flag, 8, on both sides).

Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
from gseg_tpu.ops.pallas import extract as ref_px  # noqa: E402
from gseg_tpu.parallel import spatial as ref_spatial  # noqa: E402
from gseg_tpu.parallel import turbo_spatial as ref_ts  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.parallel.spatial import spatial_mesh  # noqa: E402
from gseg_tpu_torch.parallel.turbo_spatial import (  # noqa: E402
    segment_turbo_spatial)
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402

SPEED_GATES = (13, 32, 64, 128)
QUALITY_GATES = (8, 16, 32)
VS = (96 * 128, 1080 * 1920, 2160 * 3840, 4320 * 7680)
# (weight_buckets, the reference's variable, the port's attribute)
MODES = {0: ("GSEG_GATE_DIV", "_GATE_DIV"),
         16: ("GSEG_GATE_DIV_Q", "_GATE_DIV_Q")}
SHAPE = (96, 128)
FLOOR = 64  # both packages' _CAP_FLOOR and _RLIST_FLOOR in the runs


class _Stop(Exception):
    pass


@pytest.fixture(autouse=True)
def _fresh_reference_traces():
    """The reference reads its gates and capacity floors while it traces:
    no program traced under one test's settings outlives the test."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _set_gate(monkeypatch, wb, gate):
    var, attr = MODES[wb]
    monkeypatch.setenv(var, str(gate))
    monkeypatch.setattr(turbo, attr, gate)
    jax.clear_caches()


def _reference_caps(monkeypatch, v, wb):
    """(cap_live, pair_cap, comp_cap) as the reference's Pallas-path
    handoff passes them: the candidate pool to `boundary_extract`, the
    pair pool and the root list to `_select_compact`."""
    seen = {}
    select = ref_turbo._select_compact

    def extract(L, weights, w, cap):
        seen["cap_live"] = cap
        n = 8
        return (jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
                jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.int32),
                jnp.int32(0), jnp.bool_(False))

    def stop_at(key):
        def rec(mask, keys, cap):
            seen[key] = cap
            raise _Stop
        return rec

    monkeypatch.setattr(ref_turbo, "_use_pallas", lambda: True)
    monkeypatch.setattr(ref_px, "boundary_extract", extract)
    # a (1, v) plane that holds no memory: only its shape is read
    gst = ref_turbo.GossipState(
        L=np.broadcast_to(np.int32(0), (1, v)), S=None, ID=None,
        merged=None, it=None, bucket=None, flags=None)
    cfg = RefConfig(weight_buckets=wb)
    monkeypatch.setattr(ref_turbo, "_select_compact", stop_at("pair_cap"))
    with pytest.raises(_Stop):
        ref_turbo._extract_stage(gst, None, cfg)
    monkeypatch.setattr(ref_turbo, "_select_compact", stop_at("comp_cap"))
    z = jnp.zeros(4, jnp.int32)
    with pytest.raises(_Stop):
        ref_turbo._pools_to_state(
            z > 0, z, z, z.astype(jnp.float32), z, jnp.bool_(False), v,
            cfg, z, z.astype(jnp.float32), jnp.int32(0), jnp.int32(0))
    monkeypatch.setattr(ref_turbo, "_select_compact", select)
    return seen


@pytest.mark.parametrize("v", VS)
@pytest.mark.parametrize("wb,gate", [(0, g) for g in SPEED_GATES]
                         + [(16, g) for g in QUALITY_GATES])
def test_capacities_follow_the_gate_as_the_reference(monkeypatch, wb, gate,
                                                     v):
    _set_gate(monkeypatch, wb, gate)
    want = _reference_caps(monkeypatch, v, wb)
    got = turbo.capacities(v, wb)
    assert {k: got[k] for k in want} == want
    # the reference's gate readers see the variable the port's attribute
    # mirrors
    assert (ref_turbo._gate_div_q() if wb else ref_turbo._gate_div()) == gate


@pytest.mark.parametrize("v", VS)
@pytest.mark.parametrize("wb", [0, 16])
def test_default_gates_keep_the_default_capacities(monkeypatch, wb, v):
    """At the default gates nothing moves: the divisors the port used
    before the capacities followed the gate."""
    for var, attr in MODES.values():
        monkeypatch.delenv(var, raising=False)
    assert (turbo._GATE_DIV, turbo._GATE_DIV_Q) == (128, 32)
    floor = turbo._CAP_FLOOR
    caps = turbo.capacities(v, wb)
    q = wb > 0
    assert caps["cap_live"] == max(v // 2, 1 << 16)
    assert caps["pair_cap"] == max(v // (6 if q else 24), floor)
    assert caps["comp_cap"] == max(v // (24 if q else 96), floor)
    s2 = turbo._s2_capacities(v, q)
    assert s2 == {"rec1_cap": max(v // (8 if q else 64), floor),
                  "rec2_cap": max(v // 128, floor // 2),
                  "comp_cap2": max(v // 1024, 4096),
                  "small_div": turbo._S2_SMALL_DIV_Q if q
                  else turbo._S2_SMALL_DIV}


def _shrink_floors(monkeypatch):
    for mod in (turbo, ref_turbo):
        monkeypatch.setattr(mod, "_CAP_FLOOR", FLOOR)
        monkeypatch.setattr(mod, "_RLIST_FLOOR", FLOOR)


def _cfg(wb):
    return SegmentationConfig(k=100.0, min_size=8, weight_buckets=wb)


def _ref_cfg(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


GATE_CASES = [(0, 13), (0, 32), (16, 8), (16, 16)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("wb,gate", GATE_CASES)
def test_early_gates_match_reference(monkeypatch, wb, gate, seed):
    """Byte-equal labels and flags at the early gates; the default gate's
    handoff there is later (more gossip rounds), so the two gates take
    different capacities on the same image."""
    _shrink_floors(monkeypatch)
    img = blobs_image(*SHAPE, 8, 6.0, seed)
    cfg = _cfg(wb)
    _set_gate(monkeypatch, wb, gate)
    want, want_flags = ref_turbo.segment_turbo_flagged(
        jnp.asarray(img), _ref_cfg(cfg), 2)
    labels, flags = turbo.segment_turbo_flagged(torch.from_numpy(img), cfg,
                                                2)
    assert flags == int(want_flags)
    assert flags == (turbo.FLAG_RECOMPACT_OVERFLOW if (wb, gate) == (16, 8)
                     else 0)
    assert np.array_equal(labels.numpy(), np.asarray(want))


@pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 virtual devices")
@pytest.mark.parametrize("wb,gate", [(0, 13), (16, 16)])
def test_early_gates_row_sharded_match_reference(monkeypatch, wb, gate):
    """The row-sharded path builds its stage-2 state with the dense
    handoff's gate-following root list, as the reference's does."""
    _shrink_floors(monkeypatch)
    img = blobs_image(*SHAPE, 8, 6.0, 0)
    cfg = _cfg(wb)
    _set_gate(monkeypatch, wb, gate)
    want, want_flags = ref_ts.segment_turbo_spatial(
        jnp.asarray(img), _ref_cfg(cfg),
        ref_spatial.spatial_mesh(jax.devices()[:4]), gossip_rounds=2)
    labels, flags = segment_turbo_spatial(img, cfg, spatial_mesh(["cpu"] * 4),
                                          gossip_rounds=2)
    assert flags == int(want_flags) == 0
    assert np.array_equal(labels.numpy(), np.asarray(want))

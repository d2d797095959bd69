"""The port's pad/unpad wrappers on the CPU: fill words, argument checks,
and ragged wide planes against the JAX reference.

On the CPU the wrappers run their plain PyTorch versions, after the same
checks that guard the CUDA kernels (`csrc/pad.cu`), so a call the kernel
would refuse fails here too. The reference runs
`gseg_tpu.ops.pallas.gossip._fast_pad_fields` / `_fast_unpad_fields` in
Mosaic's TPU interpret mode, as tests/test_torch_gossip.py does. The
kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gseg_tpu.ops.pallas import gossip as pg  # noqa: E402
from gseg_tpu_torch.ops.kernels import gossip as kg  # noqa: E402
from gseg_tpu_torch.ops.kernels import pad as kp  # noqa: E402


def _variant_fills():
    """(fill, dtype) of every plane the padded route pads: each variant's
    read-only plane (int32) and its read-write fields (float32 where the
    fill is a float)."""
    pairs = []
    for _, ro_fill, fills in kg._VARIANTS.values():
        for f, dt in [(ro_fill, torch.int32)] + [
                (f, torch.float32 if isinstance(f, float) else torch.int32)
                for f in fills]:
            if (f, dt) not in pairs:
                pairs.append((f, dt))
    return pairs


FILLS = _variant_fills() + [(-0.0, torch.float32),
                            (math.nan, torch.float32),
                            (-(2 ** 31), torch.int32)]


def test_variant_fills_cover_the_inert_words():
    fills = {f for f, _ in _variant_fills()}
    assert {-1, 0, 8, kg.INT32_MAX, kg.BIGDIST, math.inf, 0.0} <= fills


@pytest.mark.parametrize("fill,dtype", FILLS,
                         ids=[f"{f}-{str(d)[6:]}" for f, d in FILLS])
def test_fill_word_equals_torch_bits(fill, dtype):
    want = int(torch.tensor([fill], dtype=dtype).view(torch.int32)) \
        & 0xFFFFFFFF
    assert kp._fill_word(fill, dtype) == want
    # and the plain pad writes that word outside the data block
    x = torch.zeros((2, 3), dtype=dtype)
    p = kp.fast_pad_fields([(x, fill)], 1, 2, 5)[0]
    assert int(p[0, 0:1].view(torch.int32)) & 0xFFFFFFFF == want
    assert int(p[1, 4:5].view(torch.int32)) & 0xFFFFFFFF == want


def test_fill_word_refuses_what_the_plane_cannot_hold():
    with pytest.raises(ValueError):
        kp._fill_word(2 ** 31, torch.int32)
    with pytest.raises(ValueError):
        kp._fill_word(0.5, torch.int32)


def _planes(n, shape=(5, 7), dtype=torch.int32):
    return [torch.zeros(shape, dtype=dtype) for _ in range(n)]


# what the kernel refuses, as (pad fields, t, hp, wp) for fast_pad_fields
PAD_REFUSED = {
    "int64": ([(x, 0) for x in _planes(2, dtype=torch.int64)], 8, 32, 128),
    "float64": ([(x, 0.0) for x in _planes(1, dtype=torch.float64)], 8, 32,
                128),
    "no_fields": ([], 8, 32, 128),
    "five_fields": ([(x, 0) for x in _planes(5)], 8, 32, 128),
    "shapes_differ": ([(torch.zeros((5, 7), dtype=torch.int32), 0),
                       (torch.zeros((5, 8), dtype=torch.int32), 0)],
                      8, 32, 128),
    "non_contiguous": ([(torch.zeros((7, 5), dtype=torch.int32).t(), 0)],
                       8, 32, 128),
    "one_dim": ([(torch.zeros(35, dtype=torch.int32), 0)], 8, 32, 128),
    "hp_below_h": ([(x, 0) for x in _planes(2)], 8, 4, 128),
    "wp_below_w": ([(x, 0) for x in _planes(2)], 8, 32, 6),
    "negative_t": ([(x, 0) for x in _planes(2)], -1, 32, 128),
}


@pytest.mark.parametrize("case", sorted(PAD_REFUSED))
def test_pad_refuses_on_cpu(case):
    fields, t, hp, wp = PAD_REFUSED[case]
    with pytest.raises(ValueError):
        kp.fast_pad_fields(fields, t, hp, wp)


# as (padded planes, t, h, w) for fast_unpad_fields
UNPAD_REFUSED = {
    "int64": (_planes(2, (48, 128), torch.int64), 8, 30, 100),
    "float64": (_planes(1, (48, 128), torch.float64), 8, 30, 100),
    "no_fields": ([], 8, 30, 100),
    "five_fields": (_planes(5, (48, 128)), 8, 30, 100),
    "shapes_differ": (_planes(1, (48, 128)) + _planes(1, (48, 256)), 8, 30,
                      100),
    "non_contiguous": ([torch.zeros((128, 48), dtype=torch.int32).t()], 8,
                       30, 100),
    "hpad_below_t_plus_h": (_planes(2, (48, 128)), 8, 41, 100),
    "wp_below_w": (_planes(2, (48, 128)), 8, 30, 129),
}


@pytest.mark.parametrize("case", sorted(UNPAD_REFUSED))
def test_unpad_refuses_on_cpu(case):
    planes, t, h, w = UNPAD_REFUSED[case]
    with pytest.raises(ValueError):
        kp.fast_unpad_fields(planes, t, h, w)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# (h, w, t, hp, wp): ragged wide planes (w % 4 != 0: the register route on
# the card), an aligned one with wp > w (the bulk route with fill columns),
# and t = 0.
RAGGED_CASES = [(9, 2563, 8, 32, 2688), (9, 2600, 8, 32, 2688),
                (5, 2599, 0, 32, 2688)]


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("k", [1, 4])
def test_ragged_pad_unpad_match_pallas(case, k):
    h, w, t, hp, wp = case
    rng = np.random.default_rng(h * w + k)
    fields = [(rng.integers(-9, 9, (h, w)).astype(np.int32), -1),
              (rng.uniform(0, 1, (h, w)).astype(np.float32), float("inf")),
              (rng.integers(0, 99, (h, w)).astype(np.int32), kg.BIGDIST),
              (rng.integers(0, 256, (h, w)).astype(np.int32), 8)][:k]
    with pltpu.force_tpu_interpret_mode():
        ref = pg._fast_pad_fields([(jnp.asarray(x), f) for x, f in fields],
                                  t, hp, wp)
        ref_back = pg._fast_unpad_fields(ref, t, h, w)
    got = kp.fast_pad_fields([(_t(x), f) for x, f in fields], t, hp, wp)
    assert len(got) == k
    for r, g in zip(ref, got):
        assert g.shape == (hp + 2 * t, wp) and g.dtype == _t(r).dtype
        assert torch.equal(_t(r), g)
    back = kp.fast_unpad_fields(got, t, h, w)
    for r, g, (x, _) in zip(ref_back, back, fields):
        assert torch.equal(_t(r), g) and torch.equal(_t(x), g)

"""PyTorch port's turbo path vs the JAX reference's Pallas path, byte for
byte.

The reference runs `segment_turbo_impl` with its Pallas kernels forced on
and in Mosaic's TPU interpret mode, in its default configuration
(`GSEG_PEEL_SIZES` unset: the subsum peel) and with the dist-free peel
(`GSEG_PEEL_SIZES=count`, `turbo._PEEL_SIZES = "count"` on the port's
side); the port runs on the CPU with its plain PyTorch versions. Labels
must be byte-equal and the FLAG bits equal. Each reference run takes
~10-25 s here, so the cases are few.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.utils.synthetic import blobs_image  # noqa: E402


CASES = [
    dict(shape=(24, 40), blobs=5, seed=7, k=100.0, min_size=8, rounds=2),
    dict(shape=(24, 40), blobs=5, seed=7, k=100.0, min_size=8, rounds=4),
    dict(shape=(33, 17), blobs=5, seed=1, k=300.0, min_size=20, rounds=2),
]


@pytest.mark.parametrize("case", CASES)
def test_labels_and_flags_match_pallas_path(monkeypatch, case):
    """The dist-free (count) peel on both sides."""
    monkeypatch.setenv("GSEG_PEEL_SIZES", "count")
    monkeypatch.setattr(turbo, "_PEEL_SIZES", "count")
    _check_against_reference(monkeypatch, case)


@pytest.mark.parametrize("case", CASES)
def test_default_subsum_peel_matches_pallas_path(monkeypatch, case):
    """Both packages in their default configuration: the subsum peel."""
    monkeypatch.delenv("GSEG_PEEL_SIZES", raising=False)
    assert turbo._PEEL_SIZES == ref_turbo._peel_sizes() == "subsum"
    _check_against_reference(monkeypatch, case)


def _check_against_reference(monkeypatch, case):
    monkeypatch.setattr(ref_turbo, "_use_pallas", lambda: True)
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"])
    img = blobs_image(*case["shape"], case["blobs"], 6.0, case["seed"])
    with pltpu.force_tpu_interpret_mode():
        ref_labels, ref_flags = ref_turbo.segment_turbo_impl(
            jnp.asarray(img), RefConfig(**dataclasses.asdict(cfg)),
            case["rounds"])
    labels, flags = turbo.segment_turbo_impl(torch.from_numpy(img), cfg,
                                             case["rounds"])
    assert flags == int(ref_flags) == 0
    assert labels.dtype == torch.int32
    assert np.array_equal(np.asarray(ref_labels), labels.numpy())

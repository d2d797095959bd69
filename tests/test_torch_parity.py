"""The hardware parity protocol (`gseg_tpu_torch.bench.parity`, the port of
`scripts/check_tpu_parity.py`) on the CPU.

- On 3 seeds of the synthetic sweep (161x241, k 30, min_size 10) and on
  textured 96x160 at k 10, min_size 10, in speed and quality mode, the
  port's turbo labels and flags are byte-equal to the reference's
  `segment_turbo_flagged` (its plain XLA route, as its own tests run it on
  the CPU), and the protocol's rows are equal to the oracle with flags 0.
- The protocol's rows are the reference's (20 seeds, then 540p blobs and
  textured on the reference's own images), plus the textured 1080p k10
  wb16 row against its committed oracle.
- `main` exits non-zero when a row's oracle differs, passes when none
  does, and raises without a card unless the CPU is asked for.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.models import turbo as ref_turbo  # noqa: E402
from gseg_tpu.utils.datasets import (  # noqa: E402
    synthetic_quality_set as ref_quality_set)
from gseg_tpu.utils.synthetic import (  # noqa: E402
    blobs_image as ref_blobs, textured_image as ref_textured)
from gseg_tpu_torch.bench import parity  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.models import turbo  # noqa: E402
from gseg_tpu_torch.oracles import load_oracle, oracle_path  # noqa: E402

CPU = torch.device("cpu")


def _both(image, cfg):
    want, want_flags = ref_turbo.segment_turbo_flagged(
        jnp.asarray(image), RefConfig(**dataclasses.asdict(cfg)), 2)
    got, flags = turbo.segment_turbo_flagged(torch.from_numpy(image), cfg, 2)
    assert got.dtype == torch.int32
    assert flags == int(want_flags) == 0
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_sweep_seed_byte_equal_to_reference_and_oracle(seed):
    case = parity.cases(seeds=3, skip_540p=True)[seed]
    name, image, _ = list(ref_quality_set(n=3))[seed]
    assert case.name == name and np.array_equal(case.image, image)
    assert case.cfg == parity.SWEEP_CFG == SegmentationConfig(k=30.0,
                                                              min_size=10)
    _both(case.image, case.cfg)
    row = parity.check(case, CPU)
    assert row["equal"] and row["flags"] == 0 and row["pixels_differ"] == 0
    assert row["components"] > 1


@pytest.mark.parametrize("wb", [0, 16])
def test_textured_k10_byte_equal_to_reference(wb):
    image = ref_textured(96, 160, seed=0)
    _both(image, SegmentationConfig(k=10.0, min_size=10, weight_buckets=wb))


def test_rows_are_the_reference_protocol_and_the_textured_row():
    cases = parity.cases()
    assert [c.name for c in cases[:20]] == [
        name for name, _, _ in ref_quality_set(n=20)]
    names = [c.name for c in cases[20:]]
    assert names == ["540p blobs", "540p textured", "1080p textured k10 wb16"]
    blobs, textured, k10 = cases[20:]
    assert np.array_equal(blobs.image, ref_blobs(540, 960, num_blobs=8,
                                                 seed=0))
    assert np.array_equal(textured.image, ref_textured(540, 960, seed=0))
    assert blobs.cfg == textured.cfg == SegmentationConfig(k=300.0,
                                                           min_size=100)
    assert np.array_equal(k10.image, ref_textured(1080, 1920, seed=0))
    assert (k10.cfg.k, k10.cfg.min_size, k10.cfg.weight_buckets) == (
        10.0, 10, 16)
    oracle = k10.oracle()
    assert np.array_equal(oracle, load_oracle(oracle_path(
        "textured_1080x1920_k10_wb16")))
    assert np.unique(oracle).size == 162


def test_main_passes_on_the_cpu(capsys):
    parity.main(["--seeds", "2", "--skip-540p", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out == ["synthetic000: flags=0 equal=True",
                   "synthetic001: flags=0 equal=True",
                   "ALL PARITY CHECKS PASSED"]


def test_main_exits_nonzero_when_an_oracle_differs(monkeypatch, capsys):
    real = parity.segment_boruvka_np

    def shifted(image, cfg):
        labels = real(image, cfg).copy()
        labels[0, 0] = labels.max() + 1  # one pixel split off
        return labels

    monkeypatch.setattr(parity, "segment_boruvka_np", shifted)
    with pytest.raises(SystemExit) as exc:
        parity.main(["--seeds", "2", "--skip-540p", "--device", "cpu"])
    assert exc.value.code == "PARITY FAILURES: 2"
    assert "synthetic000: flags=0 equal=False" in capsys.readouterr().out


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.main(["--seeds", "1", "--skip-540p"])

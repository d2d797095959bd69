"""The port's quality protocol on the CPU against `gseg_tpu`: the scene
generator, the datasets, the quality harness and its CLI.

- `bsds_like_scene` (image and every pseudo-ground-truth),
  `bsds_like_quality_set`, `synthetic_quality_set` and `load_bsds500` (a
  tiny BSDS500 tree written here with PIL and `scipy.io.savemat`)
  byte-equal to the reference's.
- `run_quality_benchmark` rows equal to the reference's, float for float,
  on `synthetic_quality_set(n=2, h=48, w=64)` with the host routes
  boruvka_cpu, kruskal_cpu and kruskal_native; `summarize_quality` equal.
- `segment_level_fn("fastmst", level=2)` equal to plane 2 of the port's
  own fastmst hierarchy.
- The committed record `bench_out/bsds_quality.jsonl` (made by the
  reference at K=80, min_size 100, level 4): image 0 of
  `bsds_like_quality_set` gives its rows exactly under the reference's
  kruskal_native and boruvka_cpu, and under the port's kruskal_native,
  boruvka_cpu, fastmst (level 4) and superpixel (level 4). The card runs
  all 140 rows (chip_smoke.py, phase bsds_like_quality).
- `python -m gseg_tpu_torch.bench quality` writes quality.jsonl, its
  figure quality.png (matplotlib is installed here) and one summary line;
  `perf` without --device raises RuntimeError without a card, as every
  entry point of the port does (tests/test_torch_bench_perf.py holds the
  ladder). Its default output goes to the port's gitignored
  `bench_out/torch/`, never over the reference's committed
  `bench_out/quality.jsonl`.
Every comparison is exact.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gseg_tpu.bench import harness as ref_harness  # noqa: E402
from gseg_tpu.config import SegmentationConfig as RefConfig  # noqa: E402
from gseg_tpu.utils import datasets as ref_datasets  # noqa: E402
from gseg_tpu.utils import synthetic as ref_synthetic  # noqa: E402
import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch.bench import __main__ as bench_main  # noqa: E402
from gseg_tpu_torch.bench import harness  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.metrics.compare import asa_ue_best_gt  # noqa: E402
from gseg_tpu_torch.utils import datasets, synthetic  # noqa: E402
from gseg_tpu_torch.utils.labels import compact_labels_np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "bench_out", "bsds_quality.jsonl")


def _samples_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for (n, img, gts), (rn, rimg, rgts) in zip(got, want):
        assert n == rn and img.dtype == rimg.dtype == np.uint8
        assert np.array_equal(img, rimg) and len(gts) == len(rgts)
        for g, rg in zip(gts, rgts):
            assert g.dtype == rg.dtype and np.array_equal(g, rg)


@pytest.mark.parametrize("h,w,regions,seed", [
    (321, 481, 90, 0), (64, 96, 20, 3), (33, 40, 90, 5)])
def test_bsds_like_scene_byte_equal(h, w, regions, seed):
    img, gts = synthetic.bsds_like_scene(h, w, n_regions=regions, seed=seed)
    rimg, rgts = ref_synthetic.bsds_like_scene(h, w, n_regions=regions,
                                               seed=seed)
    _samples_equal([("s", img, gts)], [("s", rimg, rgts)])
    sizes = [np.unique(g).size for g in gts]
    assert sizes == sorted(sizes)  # coarse -> fine


def test_quality_sets_byte_equal():
    _samples_equal(datasets.synthetic_quality_set(n=2, h=48, w=64),
                   ref_datasets.synthetic_quality_set(n=2, h=48, w=64))
    _samples_equal(datasets.bsds_like_quality_set(n=2, h=40, w=60, seed0=3),
                   ref_datasets.bsds_like_quality_set(n=2, h=40, w=60,
                                                      seed0=3))


def test_load_bsds500_byte_equal(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    scipy_io = pytest.importorskip("scipy.io")
    root = tmp_path / "BSDS500"
    (root / "images" / "val").mkdir(parents=True)
    (root / "groundTruth" / "val").mkdir(parents=True)
    for i in range(3):
        img, gts = synthetic.bsds_like_scene(24, 36, n_regions=8, seed=i)
        name = f"{100 + i}"
        Image.fromarray(img).save(root / "images" / "val" / f"{name}.jpg")
        if i == 1:
            continue  # an image without ground truth is skipped
        cell = np.empty((1, len(gts)), dtype=object)
        for j, g in enumerate(gts):
            cell[0, j] = {"Segmentation": g.astype(np.uint16) + 1,
                          "Boundaries": np.zeros(g.shape, np.uint8)}
        scipy_io.savemat(root / "groundTruth" / "val" / f"{name}.mat",
                         {"groundTruth": cell})
    assert datasets.bsds500_available(str(root))
    assert not datasets.bsds500_available(None)
    assert not datasets.bsds500_available(str(tmp_path / "nope"))
    got = list(datasets.load_bsds500(str(root), "val"))
    assert [n for n, _, _ in got] == ["100", "102"]
    assert len(got[0][2]) >= 2 and got[0][2][0].dtype == np.int32
    _samples_equal(got, ref_datasets.load_bsds500(str(root), "val"))
    _samples_equal(datasets.load_bsds500(str(root), "val", limit=1),
                   ref_datasets.load_bsds500(str(root), "val", limit=1))


HOST_ROUTES = ("boruvka_cpu", "kruskal_cpu", "kruskal_native")


def test_run_quality_benchmark_rows_equal_reference(tmp_path):
    cfg = SegmentationConfig(k=80.0, min_size=10)
    out = str(tmp_path / "q.jsonl")
    rows = harness.run_quality_benchmark(
        datasets.synthetic_quality_set(n=2, h=48, w=64), HOST_ROUTES, cfg,
        out_path=out, device="cpu")
    want = ref_harness.run_quality_benchmark(
        ref_datasets.synthetic_quality_set(n=2, h=48, w=64), HOST_ROUTES,
        RefConfig(k=80.0, min_size=10))
    assert rows == want and len(rows) == 6
    with open(out) as f:
        assert [json.loads(line) for line in f] == rows
    assert harness.summarize_quality(rows) == ref_harness.summarize_quality(
        want)


def test_segment_level_fn_is_the_hierarchy_plane():
    img = synthetic.blobs_image(36, 48, 5, 8.0, 2)
    cfg = SegmentationConfig(k=80.0, min_size=10, algorithm="fastmst")
    levels, _ = gseg_tpu_torch.segment_hierarchy(img, config=cfg,
                                                 device="cpu")
    got = harness.segment_level_fn("fastmst", cfg, level=2, device="cpu")(img)
    assert got.device.type == "cpu" and torch.equal(got, levels[2])
    last = harness.segment_level_fn("fastmst", cfg, level=99,
                                    device="cpu")(img)
    assert torch.equal(last, levels[-1])
    # single-level routes return their final labels
    got = harness.segment_level_fn("kruskal_native", cfg, device="cpu")(img)
    assert torch.equal(got, gseg_tpu_torch.segment(
        img, config=SegmentationConfig(k=80.0, min_size=10,
                                       algorithm="kruskal_native"),
        device="cpu"))
    with pytest.raises(ValueError, match="unknown algorithm"):
        harness.segment_fn("nope", cfg, device="cpu")


def _record_row(image, algorithm):
    with open(RECORD) as f:
        for line in f:
            r = json.loads(line)
            if r["image"] == image and r["algorithm"] == algorithm:
                return r["asa"], r["ue"]
    raise KeyError((image, algorithm))


@pytest.fixture(scope="module")
def bsds_image0():
    return next(iter(datasets.bsds_like_quality_set(n=1)))


QCFG = dict(k=80.0, min_size=100, on_overflow="fallback")


@pytest.mark.parametrize("algorithm", ["kruskal_native", "boruvka_cpu"])
def test_record_holds_through_the_reference(bsds_image0, algorithm):
    name, image, gts = bsds_image0
    fn = ref_harness.segment_level_fn(algorithm, RefConfig(**QCFG), level=4)
    labels = np.asarray(fn(image))
    got = asa_ue_best_gt(compact_labels_np(labels), gts)
    assert got == _record_row(name, algorithm)


@pytest.mark.parametrize("algorithm", ["kruskal_native", "boruvka_cpu",
                                       "fastmst", "superpixel"])
def test_record_holds_through_the_port(bsds_image0, algorithm):
    name, image, gts = bsds_image0
    fn = harness.segment_level_fn(algorithm, SegmentationConfig(**QCFG),
                                  level=4, device="cpu")
    labels = fn(image)
    assert labels.dtype == torch.int32 and labels.shape == image.shape[:2]
    got = asa_ue_best_gt(compact_labels_np(labels.numpy()), gts)
    assert got == _record_row(name, algorithm)


def test_bench_cli(tmp_path, capsys):
    assert bench_main.main(["quality", "--algorithms",
                            "kruskal_native,boruvka_cpu", "--synthetic-n",
                            "1", "--device", "cpu", "--out-dir",
                            str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["source"] == "synthetic"
    assert set(line["summary"]) == {"kruskal_native", "boruvka_cpu"}
    with open(tmp_path / "quality.jsonl") as f:
        rows = [json.loads(x) for x in f]
    assert [r["algorithm"] for r in rows] == ["kruskal_native", "boruvka_cpu"]
    assert (tmp_path / "quality.png").read_bytes()[:4] == b"\x89PNG"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_main.main(["perf", "--out-dir", str(tmp_path)])


def test_bench_cli_default_out_dir(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert bench_main.main(["quality", "--algorithms", "kruskal_native",
                            "--synthetic-n", "1", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert sorted(p.relative_to(tmp_path).as_posix()
                  for p in tmp_path.rglob("*") if p.is_file()) == [
        "bench_out/torch/quality.jsonl", "bench_out/torch/quality.png"]
    # the default lies in a gitignored folder, not on a committed record
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "/bench_out/torch/" in f.read().split()

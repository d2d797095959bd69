"""The port's user surface on the CPU against `gseg_tpu`: image I/O, the
CLI (`python -m gseg_tpu_torch`) and `colorize`.

- `image_io`: PPM/PGM round trips, a PGM read as 3 channels, header
  comments, and a PNG through PIL, each equal to the reference's
  `read_image` byte for byte; without PIL a .png raises RuntimeError.
- The CLI with `--device cpu`: `--labels-out` equal to
  `compact_labels_np(segment(..., device="cpu"))` and, on a route that
  needs no jit, to the reference CLI's file byte for byte; the `--time`
  line's keys equal to the reference's; `--hierarchy-dir` one file per
  level, each level's colours those of `colorize_hierarchy`; the real
  entry point as a subprocess. Without a CUDA device and without
  `--device` it raises RuntimeError.
- `colorize`: one colour per component, every channel in [30, 256), the
  same colours on every level of `colorize_hierarchy` as per level.
Every comparison is exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gseg_tpu import cli as ref_cli  # noqa: E402
from gseg_tpu.utils import image_io as ref_io  # noqa: E402
import gseg_tpu_torch  # noqa: E402
from gseg_tpu_torch import cli  # noqa: E402
from gseg_tpu_torch.config import SegmentationConfig  # noqa: E402
from gseg_tpu_torch.utils import image_io  # noqa: E402
from gseg_tpu_torch.utils.labels import (  # noqa: E402
    colorize, colorize_hierarchy, compact_labels_np)
from gseg_tpu_torch.utils.synthetic import (  # noqa: E402
    blobs_image, textured_image)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(1, 7, 3), (13, 9, 3), (13, 9)])
def test_ppm_round_trip_equals_reference(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape).astype(np.uint8)
    ext = ".ppm" if len(shape) == 3 else ".pgm"
    path = str(tmp_path / f"a{ext}")
    image_io.write_image(path, img)
    ref_path = str(tmp_path / f"b{ext}")
    ref_io.write_image(ref_path, img)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    assert np.array_equal(image_io.read_ppm(path), img)
    got = image_io.read_image(path)
    assert got.shape == shape[:2] + (3,) and got.dtype == np.uint8
    assert np.array_equal(got, ref_io.read_image(path))
    if len(shape) == 2:  # a grey image comes back with three equal channels
        assert all(np.array_equal(got[..., c], img) for c in range(3))


def test_ppm_header_comments_and_bad_magic(tmp_path):
    img = textured_image(5, 6, seed=1)
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# made by hand\n6 # width\n5\n# maxval next\n255\n"
                     + img.tobytes())
    assert np.array_equal(image_io.read_image(str(path)), img)
    assert np.array_equal(image_io.read_image(str(path)),
                          ref_io.read_image(str(path)))
    bad = tmp_path / "d.ppm"
    bad.write_bytes(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="PNM magic"):
        image_io.read_ppm(str(bad))


def test_png_through_pil_and_without_it(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    img = blobs_image(17, 23, 4, 8.0, 2)
    path = str(tmp_path / "e.png")
    image_io.write_image(path, img)
    got = image_io.read_image(path)
    assert np.array_equal(got, img)
    assert np.array_equal(got, ref_io.read_image(path))
    monkeypatch.setattr(image_io, "_PILImage", None)
    with pytest.raises(RuntimeError, match="PIL unavailable"):
        image_io.read_image(path)
    with pytest.raises(RuntimeError, match="PIL unavailable"):
        image_io.write_image(path, img)


def _write_input(tmp_path, h=30, w=40, blobs=5, seed=3):
    img = blobs_image(h, w, blobs, 6.0, seed)
    path = str(tmp_path / "in.ppm")
    image_io.write_ppm(path, img)
    return img, path


def _run(argv, capsys):
    assert cli.main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("algorithm", ["turbo", "kruskal_native"])
def test_cli_labels_equal_segment(tmp_path, capsys, algorithm):
    img, inp = _write_input(tmp_path)
    out, lab = str(tmp_path / "out.ppm"), str(tmp_path / "l.npy")
    line = _run([inp, out, "--device", "cpu", "--k", "150", "--min-size",
                 "20", "--algorithm", algorithm, "--labels-out", lab,
                 "--time"], capsys)
    cfg = SegmentationConfig(k=150.0, min_size=20, algorithm=algorithm)
    want = gseg_tpu_torch.segment(img, config=cfg, device="cpu")
    got = np.load(lab)
    assert got.dtype == np.int32
    assert np.array_equal(got, compact_labels_np(want.numpy()))
    rec = json.loads(line)
    assert rec["algorithm"] == algorithm and rec["shape"] == [30, 40, 3]
    assert rec["components"] == np.unique(got).size
    # the rendering: one colour per component, as colorize paints it
    render = image_io.read_image(out)
    assert np.array_equal(render, colorize(want).numpy())


def test_cli_matches_reference_cli(tmp_path, capsys):
    """On a host route (no jit) the two CLIs save the same labels file and
    print a --time line with the same keys and counts."""
    _, inp = _write_input(tmp_path, seed=4)
    args = ["--algorithm", "boruvka_cpu", "--k", "150", "--min-size", "20",
            "--time"]
    line = _run([inp, str(tmp_path / "o.ppm"), "--device", "cpu",
                 "--labels-out", str(tmp_path / "l.npy")] + args, capsys)
    assert ref_cli.main([inp, str(tmp_path / "r.ppm"), "--labels-out",
                         str(tmp_path / "r.npy")] + args) == 0
    ref_line = capsys.readouterr().out
    assert (open(tmp_path / "l.npy", "rb").read()
            == open(tmp_path / "r.npy", "rb").read())
    got, ref = json.loads(line), json.loads(ref_line)
    assert list(got) == list(ref)
    for key in ("algorithm", "shape", "components"):
        assert got[key] == ref[key]


def test_cli_hierarchy_dir_and_level(tmp_path, capsys):
    img, inp = _write_input(tmp_path, seed=5)
    hdir = tmp_path / "hier"
    cfg = SegmentationConfig(k=150.0, min_size=20, algorithm="fastmst")
    levels, _ = gseg_tpu_torch.segment_hierarchy(img, config=cfg,
                                                 device="cpu")
    _run([inp, str(tmp_path / "h.ppm"), "--device", "cpu", "--algorithm",
          "fastmst", "--k", "150", "--min-size", "20", "--hierarchy-dir",
          str(hdir)], capsys)
    files = sorted(os.listdir(hdir))
    assert files == [f"h_level{i:02d}.ppm" for i in range(levels.shape[0])]
    coloured = colorize_hierarchy(levels).numpy()
    for i, name in enumerate(files):
        assert np.array_equal(image_io.read_image(str(hdir / name)),
                              coloured[i])
    lab = str(tmp_path / "l2.npy")
    _run([inp, str(tmp_path / "h2.ppm"), "--device", "cpu", "--algorithm",
          "fastmst", "--k", "150", "--min-size", "20", "--hierarchy-level",
          "2", "--labels-out", lab], capsys)
    assert np.array_equal(np.load(lab), compact_labels_np(levels[2].numpy()))


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    _, inp = _write_input(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([inp, str(tmp_path / "o.ppm")])


def test_cli_entry_point_subprocess(tmp_path):
    img, inp = _write_input(tmp_path, seed=6)
    lab = str(tmp_path / "l.npy")
    proc = subprocess.run(
        [sys.executable, "-m", "gseg_tpu_torch", inp,
         str(tmp_path / "o.ppm"), "--device", "cpu", "--algorithm",
         "kruskal_cpu", "--k", "150", "--min-size", "20", "--labels-out",
         lab, "--time"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    cfg = SegmentationConfig(k=150.0, min_size=20, algorithm="kruskal_cpu")
    want = compact_labels_np(
        gseg_tpu_torch.segment(img, config=cfg, device="cpu").numpy())
    assert np.array_equal(np.load(lab), want)
    assert rec["components"] == np.unique(want).size
    assert "--device" in cli.build_parser().format_help()
    assert cli.build_parser().parse_args(["a", "b"]).algorithm == "atomic"


@pytest.mark.parametrize("seed", [0, 7])
def test_colorize_one_colour_per_component(seed):
    img = blobs_image(24, 32, 6, 6.0, 1)
    cfg = SegmentationConfig(k=150.0, min_size=10, algorithm="fastmst")
    levels, labels = gseg_tpu_torch.segment_hierarchy(img, config=cfg,
                                                      device="cpu")
    rgb = colorize(labels, seed)
    assert rgb.dtype == torch.uint8 and rgb.shape == (24, 32, 3)
    assert int(rgb.min()) >= 30  # uint8: every value < 256
    flat, lab = rgb.reshape(-1, 3).numpy(), labels.reshape(-1).numpy()
    for c in np.unique(lab):
        assert np.unique(flat[lab == c], axis=0).shape[0] == 1
    assert np.unique(flat, axis=0).shape[0] == np.unique(lab).size
    stack = colorize_hierarchy(levels, seed)
    assert stack.shape == levels.shape + (3,)
    for i in range(levels.shape[0]):
        assert torch.equal(stack[i], colorize(levels[i], seed))
    assert torch.equal(colorize(labels, seed), rgb)  # a function of the seed

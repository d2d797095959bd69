"""Image I/O (port of `gseg_tpu.utils.image_io`): PPM/PGM (P6/P5) in pure
NumPy, PIL for every other format where it is installed.

PIL stays optional, as in the reference. Without it only .ppm, .pgm and
.pnm files are read and written; any other extension raises RuntimeError.
"""

from __future__ import annotations

import os

import numpy as np

try:
    from PIL import Image as _PILImage
except Exception:  # pragma: no cover
    _PILImage = None


def read_ppm(path: str) -> np.ndarray:
    """(H, W, 3) uint8 from a P6 file, (H, W) uint8 from a P5 file; header
    comments are skipped."""
    with open(path, "rb") as f:
        data = f.read()

    def tokens(buf):
        i = 0
        while i < len(buf):
            if buf[i : i + 1].isspace():
                i += 1
            elif buf[i : i + 1] == b"#":
                while i < len(buf) and buf[i : i + 1] != b"\n":
                    i += 1
            else:
                j = i
                while j < len(buf) and not buf[j : j + 1].isspace():
                    j += 1
                yield buf[i:j], j
                i = j

    it = tokens(data)
    magic, _ = next(it)
    if magic not in (b"P6", b"P5"):
        raise ValueError(f"unsupported PNM magic {magic!r}")
    (wtok, _), (htok, _), (mtok, end) = next(it), next(it), next(it)
    w, h, maxval = int(wtok), int(htok), int(mtok)
    if maxval > 255:
        raise ValueError("16-bit PNM not supported")
    raw = data[end + 1 :]
    ch = 3 if magic == b"P6" else 1
    arr = np.frombuffer(raw[: h * w * ch], dtype=np.uint8).reshape(h, w, ch)
    return arr[..., 0] if ch == 1 else arr


def write_ppm(path: str, img: np.ndarray) -> None:
    """A P5 file for an (H, W) image, P6 for (H, W, 3)."""
    img = np.asarray(img, dtype=np.uint8)
    header = b"P5" if img.ndim == 2 else b"P6"
    with open(path, "wb") as f:
        f.write(header + b"\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def read_image(path: str) -> np.ndarray:
    """Read any supported image as (H, W, 3) uint8."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".ppm", ".pgm", ".pnm"):
        img = read_ppm(path)
    elif _PILImage is not None:
        img = np.asarray(_PILImage.open(path).convert("RGB"))
    else:
        raise RuntimeError(f"no decoder for {path} (PIL unavailable)")
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img.astype(np.uint8)


def write_image(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".ppm", ".pgm", ".pnm"):
        write_ppm(path, img)
    elif _PILImage is not None:
        _PILImage.fromarray(np.asarray(img, dtype=np.uint8)).save(path)
    else:
        raise RuntimeError(f"no encoder for {path} (PIL unavailable)")

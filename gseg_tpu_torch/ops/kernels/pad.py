"""Pad and unpad the step fixpoints' fields (wide images).

Port of `gseg_tpu/ops/pallas/gossip.py:_fast_pad_fields` and
`_fast_unpad_fields`, with:

  - the kernels: `csrc/pad.cu`, one launch for up to 4 fields of 32-bit
    words each way (see the note there);
  - the plain PyTorch versions: `torch.full` plus a slice copy, and a
    slice copy.

A padded plane is (hp + 2t, wp): the (h, w) data block at rows [t, t + h),
columns [0, w), and the field's fill everywhere else. The wrappers take
the plain versions only for CPU tensors; for CUDA tensors they launch the
kernels. `fast_pad_fields.launches` and `fast_unpad_fields.launches` count
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_FIELDS = 4
_WORD_DTYPES = (torch.int32, torch.float32)


def fast_pad_fields_plain(fields, t, hp, wp):
    """[(x, fill), ...] with (h, w) planes -> list of (hp + 2t, wp)."""
    out = []
    for x, fill in fields:
        h, w = x.shape
        p = torch.full((hp + 2 * t, wp), fill, dtype=x.dtype, device=x.device)
        p[t:t + h, :w] = x
        out.append(p)
    return out


def fast_unpad_fields_plain(fields, t, h, w):
    """List of (hp + 2t, wp) planes -> list of their (h, w) data blocks."""
    return [x[t:t + h, :w].clone() for x in fields]


def _lib():
    lib = _build.load("pad")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.gseg_pad_fields.argtypes = (
        [ctypes.c_int, ptrs, ptrs, ctypes.POINTER(ctypes.c_uint32)]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.gseg_unpad_fields.argtypes = (
        [ctypes.c_int, ptrs, ptrs] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.gseg_pad_fields.restype = ctypes.c_int
    lib.gseg_unpad_fields.restype = ctypes.c_int
    return lib


def _check(xs, shape, what):
    if not 1 <= len(xs) <= MAX_FIELDS:
        raise ValueError(f"{what}: 1 to {MAX_FIELDS} fields, got {len(xs)}")
    for x in xs:
        if x.shape != shape or not x.is_contiguous() \
                or x.dtype not in _WORD_DTYPES:
            raise ValueError(f"{what}: expected contiguous int32/float32 "
                             f"{shape} planes, got {x.dtype} "
                             f"{tuple(x.shape)}")


def _fill_word(fill, dtype) -> int:
    """The 32-bit pattern of `fill` stored as `dtype`."""
    return int(torch.tensor([fill], dtype=dtype).view(torch.int32)) \
        & 0xFFFFFFFF


def _ptr_array(xs):
    return (ctypes.c_void_p * MAX_FIELDS)(*[x.data_ptr() for x in xs])


def fast_pad_fields(fields, t, hp, wp):
    """[(x, fill), ...] with (h, w) planes -> list of (hp + 2t, wp) planes
    (fill: a Python scalar of the plane's dtype)."""
    xs = [x for x, _ in fields]
    if _build.on_cpu(*xs):
        return fast_pad_fields_plain(fields, t, hp, wp)
    h, w = xs[0].shape
    _check(xs, (h, w), "fast_pad_fields")
    if t < 0 or hp < h or wp < w:
        raise ValueError(f"fast_pad_fields: cannot pad {(h, w)} with t={t} "
                         f"to hp={hp}, wp={wp}")
    outs = [torch.empty((hp + 2 * t, wp), dtype=x.dtype, device=x.device)
            for x in xs]
    fills = (ctypes.c_uint32 * MAX_FIELDS)(
        *[_fill_word(f, x.dtype) for x, f in fields])
    with torch.cuda.device(xs[0].device):
        err = _lib().gseg_pad_fields(
            len(xs), _ptr_array(xs), _ptr_array(outs), fills, h, w, t,
            hp + 2 * t, wp, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "gseg_pad_fields")
    _WRAPPERS["pad"].launches += 1
    return outs


def fast_unpad_fields(fields, t, h, w):
    """List of (hp + 2t, wp) planes -> list of their (h, w) data blocks."""
    if _build.on_cpu(*fields):
        return fast_unpad_fields_plain(fields, t, h, w)
    hpad, wp = fields[0].shape
    _check(fields, (hpad, wp), "fast_unpad_fields")
    if t < 0 or hpad < t + h or wp < w:
        raise ValueError(f"fast_unpad_fields: no {(h, w)} block at row {t} "
                         f"of {(hpad, wp)}")
    outs = [torch.empty((h, w), dtype=x.dtype, device=x.device)
            for x in fields]
    with torch.cuda.device(fields[0].device):
        err = _lib().gseg_unpad_fields(
            len(fields), _ptr_array(fields), _ptr_array(outs), h, w, t, hpad,
            wp, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "gseg_unpad_fields")
    _WRAPPERS["unpad"].launches += 1
    return outs


# Launch counts live on the wrapper objects themselves (bound here, so a
# caller that re-binds the module names still counts on the originals).
_WRAPPERS = {"pad": fast_pad_fields, "unpad": fast_unpad_fields}
for _fn in _WRAPPERS.values():
    _fn.launches = 0

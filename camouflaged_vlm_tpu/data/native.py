"""ctypes binding for libcvtpre — the native host-preprocessing library.

The reference delegates host preprocessing to torch's C++ DataLoader workers
wrapping Pillow's C decoders (`train_ovcos_maskdecoder_edge.py:66`,
`datasets/wrappers.py:22-35`).  This module is the native
equivalent: a small plain-C library (csrc/preproc) that fuses decode ->
rot90 -> resize -> normalize per sample with zero Python-object traffic, and
releases the GIL for the whole sample (ctypes calls drop the GIL), so the
loader's thread pool scales across cores where the PIL+numpy path serialises
on array conversions.

Every routine is bit-exact with the PIL path in data/transforms.py (asserted
by tests/test_native_preproc.py); `available()` gates usage so environments
without the built library fall back to PIL transparently.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

NEAREST = 0
BILINEAR = 1
BICUBIC = 2

_OK = 0
_UNSUPPORTED = 1

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


class _CvtImage(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
    ]


def _candidate_paths():
    env = os.environ.get("CVTPRE_LIB")
    if env:
        yield env
    here = os.path.dirname(os.path.abspath(__file__))
    # repo layout: camouflaged_vlm_tpu/data/ -> ../../csrc/preproc/
    yield os.path.join(here, "..", "..", "csrc", "preproc", "libcvtpre.so")
    # installed layout: alongside the package
    yield os.path.join(here, "libcvtpre.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    for path in _candidate_paths():
        path = os.path.abspath(path)
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.cvt_decode.restype = ctypes.c_int
        lib.cvt_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.POINTER(_CvtImage),
        ]
        lib.cvt_free.restype = None
        lib.cvt_free.argtypes = [ctypes.c_void_p]
        lib.cvt_resize.restype = ctypes.c_int
        lib.cvt_resize.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.cvt_rgb2l.restype = None
        lib.cvt_rgb2l.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.cvt_rot90ccw.restype = None
        lib.cvt_rot90ccw.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.cvt_fliplr.restype = None
        lib.cvt_fliplr.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.cvt_normalize.restype = None
        lib.cvt_normalize.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        break
    return _lib


def available() -> bool:
    """True when libcvtpre.so was found and loaded."""
    return _load() is not None


def decode(data: bytes, channels: int) -> Optional[np.ndarray]:
    """Decode JPEG/PNG bytes to (H, W, channels) uint8, PIL convert("RGB"/"L")
    semantics.  Returns None when the input is outside the native fast path
    (e.g. 16-bit PNG, CMYK JPEG) — caller falls back to PIL.  Raises on
    corrupt data so errors are not silently eaten."""
    lib = _load()
    assert lib is not None
    img = _CvtImage()
    rc = lib.cvt_decode(data, len(data), channels, ctypes.byref(img))
    if rc == _UNSUPPORTED:
        return None
    if rc != _OK:
        raise ValueError(f"cvt_decode failed (status {rc})")
    try:
        n = int(img.height) * int(img.width) * int(img.channels)
        arr = np.ctypeslib.as_array(img.data, shape=(n,)).copy()
    finally:
        lib.cvt_free(img.data)
    return arr.reshape(int(img.height), int(img.width), int(img.channels))


def decode_file(path: str, channels: int) -> Optional[np.ndarray]:
    with open(path, "rb") as f:
        return decode(f.read(), channels)


def resize(arr: np.ndarray, size: Tuple[int, int], filter: int) -> np.ndarray:
    """PIL Image.resize((w, h), filter) on a (H, W, C) or (H, W) uint8 array."""
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, ch = arr.shape
    dw, dh = size
    out = np.empty((dh, dw, ch), np.uint8)
    lib = _load()
    assert lib is not None
    rc = lib.cvt_resize(
        arr.ctypes.data, w, h, ch, out.ctypes.data, dw, dh, filter
    )
    if rc != _OK:
        raise ValueError(f"cvt_resize failed (status {rc})")
    return out[:, :, 0] if squeeze else out


def rgb2l(arr: np.ndarray) -> np.ndarray:
    """PIL convert("L") on a (H, W, 3) uint8 array."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, _ = arr.shape
    out = np.empty((h, w), np.uint8)
    lib = _load()
    assert lib is not None
    lib.cvt_rgb2l(arr.ctypes.data, h * w, out.ctypes.data)
    return out


def rot90ccw(arr: np.ndarray) -> np.ndarray:
    """np.rot90(arr, 1) for (H, W, C) uint8 (contiguous output)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, ch = arr.shape
    out = np.empty((w, h, ch), np.uint8)
    lib = _load()
    assert lib is not None
    lib.cvt_rot90ccw(arr.ctypes.data, w, h, ch, out.ctypes.data)
    return out


def fliplr(arr: np.ndarray) -> np.ndarray:
    """PIL FLIP_LEFT_RIGHT, returning a new contiguous array."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8).copy()
    h, w, ch = arr.shape
    lib = _load()
    assert lib is not None
    lib.cvt_fliplr(arr.ctypes.data, w, h, ch)
    return arr


def normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    """(arr/255 - mean) / std in fp32, fused (same op order as transforms)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, ch = arr.shape
    mean = np.ascontiguousarray(np.broadcast_to(mean, (ch,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (ch,)), np.float32)
    out = np.empty((h, w, ch), np.float32)
    lib = _load()
    assert lib is not None
    lib.cvt_normalize(
        arr.ctypes.data, h * w, ch, mean.ctypes.data, std.ctypes.data,
        out.ctypes.data,
    )
    return out

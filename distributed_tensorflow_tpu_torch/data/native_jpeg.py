"""The native libjpeg decode stage (ctypes over the repo's
``native/dtf_jpeg.cpp``) — the port's counterpart of
``distributed_tensorflow_tpu/data/native_jpeg.py``.

Header parse, DCT-domain downscaled decode, crop and bilinear resize run
in C++ on a thread pool, under ``JpegClassificationDataset``
(``decoder="native"``). The crop policy (which rect, which flips) stays in
Python (``augment.sample_crop_rect``): this stage only executes pixels.

The source is built on first use by ``runtime/native.build_library``
(g++ ``-O3 -std=c++17 -shared -fPIC -pthread``, linked with ``-ljpeg``)
into ``runtime/build/libdtf_jpeg-<hash>.so``; the JAX side's
``native/build/`` library is never loaded. A build or load that fails
(no g++, no libjpeg headers) logs one warning with the compiler's message
and ``available()`` is False; ``failure`` says why. Nothing runs at
import time.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

from ..runtime import native

logger = logging.getLogger(__name__)

SRC = os.path.join(native.NATIVE_DIR, "dtf_jpeg.cpp")
LIBS = ("-ljpeg",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
#: why the library is not in use (None while it is, or before the first try)
failure: str | None = None


def library_path() -> str:
    return native.library_path(SRC, LIBS)


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i64p, u8p = c.POINTER(c.c_int64), c.POINTER(c.c_uint8)
    lib.dtf_jpeg_dims.restype = c.c_int
    lib.dtf_jpeg_dims.argtypes = [u8p, i64p, i64p, c.c_int64, i64p]
    lib.dtf_jpeg_decode_crop_resize.restype = c.c_int
    lib.dtf_jpeg_decode_crop_resize.argtypes = [u8p, i64p, i64p, i64p, c.c_int64, c.c_int,
                                                u8p, c.c_int]
    return lib


def load_library() -> ctypes.CDLL | None:
    """The loaded library, built if needed; None (after one warning) when
    it cannot be built or loaded."""
    global _lib, _tried, failure
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            _lib = _configure(ctypes.CDLL(native.build_library(SRC, LIBS)))
        except subprocess.CalledProcessError as e:
            failure = f"g++ failed: {e.stderr.strip()[-2000:]}"
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            failure = f"{type(e).__name__}: {e}"
        if _lib is None:
            logger.warning("native jpeg decoder unavailable (%s); decoder='auto' takes the "
                           "PIL path", failure)
        return _lib


def available() -> bool:
    """Whether the native decoder is built, loaded and in use."""
    return load_library() is not None


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _bounded(data: np.ndarray, offsets: np.ndarray,
             lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(offset, length) pairs clamped to the data buffer: a corrupt index
    entry becomes a short stream that fails to decode (and is zero-filled),
    never a read out of bounds in C."""
    off = np.clip(np.ascontiguousarray(offsets, np.int64), 0, data.size)
    ln = np.clip(np.ascontiguousarray(lengths, np.int64), 0, data.size - off)
    return off, ln


def _library() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise OSError(f"native jpeg decoder unavailable: {failure}")
    return lib


def jpeg_dims(data: np.ndarray, offsets: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """[N, 2] (h, w) of each stream; zeros for one that does not parse."""
    lib = _library()
    n = len(offsets)
    dims = np.zeros((n, 2), np.int64)
    off, ln = _bounded(data, offsets, lengths)
    lib.dtf_jpeg_dims(_u8p(data), _i64p(off), _i64p(ln), n, _i64p(dims))
    return dims


def decode_crop_resize(data: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                       rects: np.ndarray, out_size: int, n_threads: int) -> np.ndarray:
    """N streams decoded, cropped to their rects (y, x, ch, cw in full-size
    coordinates) and resized bilinearly to [N, out_size, out_size, 3] uint8
    on ``n_threads`` threads. A stream that fails comes back zeroed (a
    zero image in a training batch is noise, not a crash), with one
    warning a call."""
    lib = _library()
    n = len(offsets)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    off, ln = _bounded(data, offsets, lengths)
    rc = np.ascontiguousarray(rects, np.int64)
    bad = lib.dtf_jpeg_decode_crop_resize(_u8p(data), _i64p(off), _i64p(ln), _i64p(rc), n,
                                          out_size, _u8p(out), n_threads)
    if bad:
        logger.warning("native jpeg decode: %d/%d streams failed (zero-filled)", bad, n)
    return out

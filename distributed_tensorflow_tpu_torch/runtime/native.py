"""Build and load the native host runtime (ctypes) — the port's own
counterpart of ``distributed_tensorflow_tpu/runtime/native.py``.

The source is the repo's ``native/dtf_runtime.cpp``, compiled on first use
with ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into this package's
``runtime/build/libdtf_runtime-<hash>.so`` (the hash covers the source
and the flags, so an edited source never loads a stale library; the
directory is listed in ``.gitignore``). It never loads the JAX side's
``native/build/`` library. Only the checksummed file IO is bound:
``dtf_write_file``, ``dtf_read_file`` and ``dtf_crc32`` (the record loader
comes with the real-data intake, ROADMAP Queue A item 3.2).

Unlike the JAX module, a failure is not silent: a build or load that
fails logs one warning with the compiler's message, and ``available()``
says whether the library is in use (``runtime/io.py`` then takes its
byte-identical Python path). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native", "dtf_runtime.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
#: why the library is not in use (None while it is, or before the first try)
failure: str | None = None


def library_path() -> str:
    """Where the build of the current source lands."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdtf_runtime-{h.hexdigest()[:16]}.so")


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.dtf_write_file.restype = c.c_int
    lib.dtf_write_file.argtypes = [c.c_char_p, c.c_void_p, c.c_int64]
    lib.dtf_read_file.restype = c.c_int64
    lib.dtf_read_file.argtypes = [c.c_char_p, c.c_void_p, c.c_int64]
    lib.dtf_crc32.restype = c.c_uint32
    lib.dtf_crc32.argtypes = [c.c_void_p, c.c_int64]
    return lib


def _build() -> str:
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a per-process tmp name: concurrent first uses (test workers, ranks)
    # each write their own file, and os.replace publishes a whole library
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, SRC, "-o", tmp], check=True, capture_output=True,
                       text=True, timeout=180)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load_library() -> ctypes.CDLL | None:
    """The loaded library, built if needed; None (after one warning) when
    it cannot be built or fails its CRC self-test."""
    global _lib, _tried, failure
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = _configure(ctypes.CDLL(_build()))
            if lib.dtf_crc32(b"123456789", 9) != 0xCBF43926:
                raise OSError("CRC32 self-test failed")
            _lib = lib
        except subprocess.CalledProcessError as e:
            failure = f"g++ failed: {e.stderr.strip()[-2000:]}"
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            failure = f"{type(e).__name__}: {e}"
        if _lib is None:
            logger.warning("native runtime unavailable (%s); runtime/io.py takes its Python "
                           "path", failure)
        return _lib


def available() -> bool:
    """Whether the native library is built, loaded and in use."""
    return load_library() is not None

"""Build and load the native host runtime (ctypes) — the port's own
counterpart of ``distributed_tensorflow_tpu/runtime/native.py``.

The source is the repo's ``native/dtf_runtime.cpp``, compiled on first use
with ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into this package's
``runtime/build/libdtf_runtime-<hash>.so`` (the hash covers the source,
the flags and the linked libraries, so an edited source never loads a
stale library; the directory is listed in ``.gitignore``). It never loads
the JAX side's ``native/build/`` library. Bound: the checksummed file IO
(``dtf_write_file``, ``dtf_read_file``, ``dtf_crc32``) that
``runtime/io.py`` uses, and the record loader that ``runtime/loader.py``
drives (``dtf_loader_create``/``_next``/``_release``/``_destroy``/
``_batches_per_epoch``/``_n_records``/``_batch_indices``,
``dtf_batch_data``, ``dtf_batch_index`` and ``dtf_epoch_permutation``).
``build_library`` is the one g++ build, also used by
``data/native_jpeg.py`` for ``native/dtf_jpeg.cpp``.

Unlike the JAX module, a failure is not silent: a build or load that
fails logs one warning with the compiler's message, and ``available()``
says whether the library is in use (``runtime/io.py`` and
``runtime/loader.py`` then take their byte-identical Python paths).
Nothing here runs at import time.
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
NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native")
SRC = os.path.join(NATIVE_DIR, "dtf_runtime.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
#: why the library is not in use (None while it is, or before the first try)
failure: str | None = None


def library_path(src: str = SRC, libs: tuple[str, ...] = ()) -> str:
    """Where the build of ``src`` (linked with ``libs``) lands."""
    h = hashlib.sha256(" ".join(FLAGS + libs).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_library(src: str = SRC, libs: tuple[str, ...] = ()) -> str:
    """``src`` built with g++ into ``BUILD_DIR`` unless already there;
    raises ``subprocess.CalledProcessError`` (the compiler's message in
    ``stderr``) or ``OSError``."""
    so = library_path(src, libs)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a per-process tmp name: concurrent first uses (test workers, ranks)
    # each write their own file, and os.replace publishes a whole library
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, src, "-o", tmp, *libs], check=True,
                       capture_output=True, text=True, timeout=180)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.dtf_write_file.restype = c.c_int
    lib.dtf_write_file.argtypes = [c.c_char_p, c.c_void_p, c.c_int64]
    lib.dtf_read_file.restype = c.c_int64
    lib.dtf_read_file.argtypes = [c.c_char_p, c.c_void_p, c.c_int64]
    lib.dtf_crc32.restype = c.c_uint32
    lib.dtf_crc32.argtypes = [c.c_void_p, c.c_int64]
    lib.dtf_loader_create.restype = c.c_void_p
    lib.dtf_loader_create.argtypes = [c.c_char_p, c.c_int64, c.c_int64, c.c_int, c.c_int,
                                      c.c_uint64, c.c_int64, c.c_int64, c.c_int64]
    lib.dtf_loader_batches_per_epoch.restype = c.c_int64
    lib.dtf_loader_batches_per_epoch.argtypes = [c.c_void_p]
    lib.dtf_loader_n_records.restype = c.c_int64
    lib.dtf_loader_n_records.argtypes = [c.c_void_p]
    lib.dtf_loader_next.restype = c.c_void_p
    lib.dtf_loader_next.argtypes = [c.c_void_p]
    lib.dtf_batch_data.restype = c.POINTER(c.c_uint8)
    lib.dtf_batch_data.argtypes = [c.c_void_p]
    lib.dtf_batch_index.restype = c.c_int64
    lib.dtf_batch_index.argtypes = [c.c_void_p]
    lib.dtf_loader_release.restype = None
    lib.dtf_loader_release.argtypes = [c.c_void_p, c.c_void_p]
    lib.dtf_loader_destroy.restype = None
    lib.dtf_loader_destroy.argtypes = [c.c_void_p]
    lib.dtf_loader_batch_indices.restype = None
    lib.dtf_loader_batch_indices.argtypes = [c.c_void_p, c.c_int64, c.POINTER(c.c_int64)]
    lib.dtf_epoch_permutation.restype = None
    lib.dtf_epoch_permutation.argtypes = [c.c_int64, c.c_uint64, c.POINTER(c.c_int64)]
    return lib


def load_library() -> ctypes.CDLL | None:
    """The loaded library, built if needed; None (after one warning) when
    it cannot be built or fails its CRC self-test."""
    global _lib, _tried, failure
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = _configure(ctypes.CDLL(build_library()))
            if lib.dtf_crc32(b"123456789", 9) != 0xCBF43926:
                raise OSError("CRC32 self-test failed")
            _lib = lib
        except subprocess.CalledProcessError as e:
            failure = f"g++ failed: {e.stderr.strip()[-2000:]}"
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            failure = f"{type(e).__name__}: {e}"
        if _lib is None:
            logger.warning("native runtime unavailable (%s); runtime/io.py and "
                           "runtime/loader.py take their Python paths", failure)
        return _lib


def available() -> bool:
    """Whether the native library is built, loaded and in use."""
    return load_library() is not None

"""Checksummed atomic payload IO — the port's counterpart of
``distributed_tensorflow_tpu/runtime/io.py``, byte for byte the same
format: the payload, then a 20-byte trailer ``[magic "DTFCKPT1"][u64 LE
length][u32 LE zlib-CRC32]``, written to ``<path>.tmp``, fsync'd, then
renamed over ``path``, so a crash mid-write never clobbers a good file.

``write_payload`` / ``read_payload`` take the native path
(``runtime/native.py``, the repo's ``native/dtf_runtime.cpp``) when its
library is in use and the Python path otherwise; both paths stay
callable on their own (``write_native``, ``write_python``, ...), and
each reads what the other writes. ``read_array`` reads a payload into a
writable uint8 array with no copy past the read (the checkpoint loads
its shards that way). The native calls release the interpreter lock, so
several threads write or read shards at once.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from . import native

MAGIC = b"DTFCKPT1"
TRAILER_BYTES = 20


def _as_bytes(data) -> np.ndarray:
    """``data`` (bytes, a buffer or an array) as a flat contiguous uint8 view."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def write_native(path: str, data) -> None:
    lib = native.load_library()
    if lib is None:
        raise OSError(f"native runtime unavailable: {native.failure}")
    buf = _as_bytes(data)
    rc = lib.dtf_write_file(os.fsencode(path), buf.ctypes.data, buf.size)
    if rc != 0:
        raise OSError(f"native write to {path} failed (rc={rc})")


def write_python(path: str, data) -> None:
    view = memoryview(_as_bytes(data))
    trailer = MAGIC + struct.pack("<QI", view.nbytes, zlib.crc32(view) & 0xFFFFFFFF)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(view)
        f.write(trailer)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_array_native(path: str) -> np.ndarray:
    lib = native.load_library()
    if lib is None:
        raise OSError(f"native runtime unavailable: {native.failure}")
    size = lib.dtf_read_file(os.fsencode(path), None, 0)
    if size < 0:
        raise OSError(f"{path}: invalid payload (rc={size})")
    out = np.empty(size, np.uint8)
    rc = lib.dtf_read_file(os.fsencode(path), out.ctypes.data, size)
    if rc == -3:
        raise OSError(f"{path}: CRC mismatch (corrupt shard)")
    if rc < 0:
        raise OSError(f"{path}: read failed (rc={rc})")
    return out


def _read_array_python(path: str) -> np.ndarray:
    raw = np.empty(os.path.getsize(path), np.uint8)
    with open(path, "rb") as f:
        if f.readinto(memoryview(raw)) != raw.size:
            raise OSError(f"{path}: short read")
    if raw.size < TRAILER_BYTES or raw[-20:-12].tobytes() != MAGIC:
        raise OSError(f"{path}: missing/invalid trailer")
    length, crc = struct.unpack("<QI", raw[-12:].tobytes())
    payload = raw[:-TRAILER_BYTES]
    if length != payload.size:
        raise OSError(f"{path}: length mismatch")
    if (zlib.crc32(memoryview(payload)) & 0xFFFFFFFF) != crc:
        raise OSError(f"{path}: CRC mismatch (corrupt shard)")
    return payload


def read_native(path: str) -> bytes:
    return _read_array_native(path).tobytes()


def read_python(path: str) -> bytes:
    return _read_array_python(path).tobytes()


def write_payload(path: str, data) -> None:
    """Write ``data`` (bytes, a buffer or an array's bytes) with its
    trailer, atomically."""
    (write_native if native.available() else write_python)(path, data)


def read_payload(path: str) -> bytes:
    """Read and CRC-verify a payload; raises OSError on truncation or
    corruption."""
    return (read_native if native.available() else read_python)(path)


def read_array(path: str) -> np.ndarray:
    """``read_payload`` into a writable uint8 array."""
    return (_read_array_native if native.available() else _read_array_python)(path)

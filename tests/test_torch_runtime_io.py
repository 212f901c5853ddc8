"""The port's checksummed atomic IO (``runtime/io.py`` over its own build of
``native/dtf_runtime.cpp``) against the JAX package's ``runtime/io.py``:
the files are byte-identical for the same payload on both of the port's
paths (native and Python), each side reads the other's files, and a
truncated file or a flipped byte raises on both sides."""

import os

import numpy as np
import pytest

from distributed_tensorflow_tpu.runtime import io as jio
from distributed_tensorflow_tpu_torch.runtime import io as tio
from distributed_tensorflow_tpu_torch.runtime import native as tnative

PAYLOADS = {
    "empty": b"",
    "text": b"checkpoint shard payload",
    "array": np.random.default_rng(0).standard_normal(4099).astype(np.float32),
}


def test_native_library_is_the_ports_own_build():
    assert tnative.available(), tnative.failure
    path = tnative.library_path()
    assert os.path.exists(path)
    assert os.sep + os.path.join("distributed_tensorflow_tpu_torch", "runtime", "build") \
        in path
    assert os.path.join("native", "build") not in path
    assert tnative.load_library().dtf_crc32(b"123456789", 9) == 0xCBF43926


@pytest.mark.parametrize("name", sorted(PAYLOADS))
@pytest.mark.parametrize("writer", ["native", "python"])
def test_files_are_byte_identical_to_jax(tmp_path, name, writer):
    data = PAYLOADS[name]
    ours, theirs = str(tmp_path / "port.dtf"), str(tmp_path / "jax.dtf")
    getattr(tio, f"write_{writer}")(ours, data)
    jio.write_payload(theirs, data)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(ours + ".tmp")


@pytest.mark.parametrize("reader", ["native", "python"])
def test_each_side_reads_the_others_files(tmp_path, reader):
    data = PAYLOADS["array"]
    jio.write_payload(str(tmp_path / "jax.dtf"), data)
    assert getattr(tio, f"read_{reader}")(str(tmp_path / "jax.dtf")) == data.tobytes()
    tio.write_payload(str(tmp_path / "port.dtf"), data)
    assert jio.read_payload(str(tmp_path / "port.dtf")) == data.tobytes()


@pytest.mark.parametrize("damage", ["truncate", "flip_payload", "flip_trailer"])
def test_damaged_files_raise_on_both_sides(tmp_path, damage):
    path = str(tmp_path / "shard.dtf")
    tio.write_payload(path, PAYLOADS["array"])
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if damage == "truncate":
            f.truncate(size - 1)
        else:
            at = 17 if damage == "flip_payload" else size - 1
            f.seek(at)
            b = f.read(1)
            f.seek(at)
            f.write(bytes([b[0] ^ 0xFF]))
    for read in (tio.read_native, tio.read_python, jio.read_payload):
        with pytest.raises(OSError):
            read(path)

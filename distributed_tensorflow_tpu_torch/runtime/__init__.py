"""The native host runtime of the port: the checksummed atomic file IO
(``io.py``) over the repo's ``native/dtf_runtime.cpp`` (``native.py``)."""

from . import io, native  # noqa: F401

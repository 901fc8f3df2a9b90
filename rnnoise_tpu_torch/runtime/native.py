"""ctypes binding for the native stream-I/O runtime — the counterpart of
``rnnoise_tpu/runtime/native.py`` over the same C ABI.

The library is the repo's unchanged ``native/streamio.cc``, compiled with
g++ at first use in a process into this package's ``_build/`` (never into
``native/``), like the CUDA kernels (``kernels.compile_libraries``).  Its
signatures and the pool's methods live in ``streamio_abi.py``, which the
fan-out's workers load without torch.
"""

from __future__ import annotations

import ctypes as ct

from .. import kernels
from . import streamio_abi

_LIB = None


def get_lib() -> ct.CDLL:
    global _LIB
    if _LIB is None:
        kernels.compile_libraries({"streamio": list(streamio_abi.BUILD_ARGV)})
        _LIB = streamio_abi.bind(kernels.library("streamio"))
    return _LIB


class StreamPool(streamio_abi.Pool):
    """Native pool of stream slots with int16 PCM rings (see streamio.cc):
    per-slot push and pull, bulk push_all and pull_all, f32 and int16
    assembly and commit, stream- or time-major, and the strided forms."""

    def __init__(self, n_slots: int, ring_frames: int = 64):
        super().__init__(get_lib(), n_slots, ring_frames)


def blob_validate(blob: bytes) -> list[str]:
    """Native DNNw blob validation; returns the array names.  Raises
    ValueError on a malformed blob."""
    names = ct.create_string_buffer(1 << 20)
    n = get_lib().rnnt_blob_validate(blob, len(blob), names, len(names))
    if n < 0:
        raise ValueError("malformed weights blob")
    return [s.decode() for s in names.raw.split(b"\x00")[:n]]

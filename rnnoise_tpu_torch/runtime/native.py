"""ctypes binding for the native stream-I/O runtime — the counterpart of
``rnnoise_tpu/runtime/native.py`` over the same C ABI.

The library is the repo's unchanged ``native/streamio.cc``, compiled with
g++ at first use in a process into this package's ``_build/`` (never into
``native/``), like the CUDA kernels (``kernels.compile_libraries``).
"""

from __future__ import annotations

import ctypes as ct
import os
from typing import Optional

import numpy as np

from .. import kernels

SOURCE = os.path.join(os.path.dirname(kernels.PKG_DIR), "native",
                      "streamio.cc")
FRAME = 480

_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

_LIB = None


def get_lib() -> ct.CDLL:
    global _LIB
    if _LIB is None:
        kernels.compile_libraries({"streamio": [
            "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            "-pthread", SOURCE]})
        lib = kernels.library("streamio")
        vp, i, i64 = ct.c_void_p, ct.c_int, ct.c_int64
        for name, res, args in (
                ("rnnt_pool_create", vp, [i, i]),
                ("rnnt_pool_destroy", None, [vp]),
                ("rnnt_pool_attach", i, [vp]),
                ("rnnt_pool_detach", None, [vp, i]),
                ("rnnt_pool_push", i64, [vp, i, _i16p, i64]),
                ("rnnt_pool_pull", i64, [vp, i, _i16p, i64]),
                ("rnnt_pool_available", i64, [vp, i]),
                ("rnnt_pool_pull_all", i, [vp, _i16p, i64]),
                ("rnnt_pool_assemble_tm_i16", None, [vp, i, _i16p, _i32p, _u8p]),
                ("rnnt_pool_commit_tm_i16", None, [vp, i, _i16p, _i32p]),
                ("rnnt_blob_validate", i, [ct.c_char_p, i64, ct.c_char_p, i64])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _LIB = lib
    return _LIB


class StreamPool:
    """Native pool of stream slots with int16 PCM rings (see streamio.cc)."""

    def __init__(self, n_slots: int, ring_frames: int = 64):
        self._p = None
        self._lib = get_lib()
        self._p = self._lib.rnnt_pool_create(n_slots, ring_frames)
        self.n_slots = n_slots

    def close(self) -> None:
        if self._p is not None:
            self._lib.rnnt_pool_destroy(self._p)
            self._p = None

    __del__ = close

    def attach(self) -> int:
        return self._lib.rnnt_pool_attach(self._p)

    def detach(self, slot: int) -> None:
        self._lib.rnnt_pool_detach(self._p, slot)

    def push(self, slot: int, pcm: np.ndarray) -> int:
        pcm = np.ascontiguousarray(pcm, np.int16)
        return self._lib.rnnt_pool_push(self._p, slot, pcm, len(pcm))

    def pull(self, slot: int, n: int) -> np.ndarray:
        out = np.empty(n, np.int16)
        got = self._lib.rnnt_pool_pull(self._p, slot, out, n)
        return out[:max(0, got)]

    def available(self, slot: int) -> int:
        return self._lib.rnnt_pool_available(self._p, slot)

    def pull_all(self, n: int, out: Optional[np.ndarray] = None):
        """Drain up to n samples per slot -> ([S, n] int16 zero-filled,
        slots that produced a full n)."""
        if out is None:
            out = np.empty((self.n_slots, n), np.int16)
        return out, self._lib.rnnt_pool_pull_all(self._p, out, n)

    def assemble_tm_i16(self, t_frames: int, out: Optional[tuple] = None):
        """Time-major int16 assembly: ([T, S, 480] int16, counts [S] int32,
        reset [S] uint8).  A slot gets all T frames or none.  Pass
        ``out=(batch, counts, reset)`` to reuse buffers across ticks."""
        S = self.n_slots
        if out is None:
            out = (np.empty((t_frames, S, FRAME), np.int16),
                   np.empty(S, np.int32), np.empty(S, np.uint8))
        batch, counts, reset = out
        if batch.shape != (t_frames, S, FRAME):
            raise ValueError(f"batch shape {batch.shape} != {(t_frames, S, FRAME)}")
        self._lib.rnnt_pool_assemble_tm_i16(self._p, t_frames, batch, counts,
                                            reset)
        return batch, counts, reset

    def commit_tm_i16(self, t_frames: int, batch: np.ndarray,
                      counts: np.ndarray) -> None:
        self._lib.rnnt_pool_commit_tm_i16(
            self._p, t_frames, np.ascontiguousarray(batch, np.int16),
            np.ascontiguousarray(counts, np.int32))


def blob_validate(blob: bytes) -> list[str]:
    """Native DNNw blob validation; returns the array names.  Raises
    ValueError on a malformed blob."""
    names = ct.create_string_buffer(1 << 20)
    n = get_lib().rnnt_blob_validate(blob, len(blob), names, len(names))
    if n < 0:
        raise ValueError("malformed weights blob")
    return [s.decode() for s in names.raw.split(b"\x00")[:n]]

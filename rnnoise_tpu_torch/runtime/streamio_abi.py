"""The C interface of ``native/streamio.cc``: its build command and the
ctypes signature of every entry point.

Needs only ctypes and numpy, so that the fan-out's worker processes
(``fanout.py``, run by path) can load it by path too: they import neither
torch nor this package.
"""

from __future__ import annotations

import ctypes as ct
import os

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "streamio.cc")
# g++ argv without the output path
BUILD_ARGV = ("g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
              "-pthread", SOURCE)
FRAME = 480

i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

_vp, _i, _i64 = ct.c_void_p, ct.c_int, ct.c_int64
SIGNATURES = (
    ("rnnt_pool_create", _vp, [_i, _i]),
    ("rnnt_pool_destroy", None, [_vp]),
    ("rnnt_pool_attach", _i, [_vp]),
    ("rnnt_pool_detach", None, [_vp, _i]),
    ("rnnt_pool_push", _i64, [_vp, _i, i16p, _i64]),
    ("rnnt_pool_pull", _i64, [_vp, _i, i16p, _i64]),
    ("rnnt_pool_available", _i64, [_vp, _i]),
    ("rnnt_pool_push_all", _i, [_vp, i16p, _i64]),
    ("rnnt_pool_pull_all", _i, [_vp, i16p, _i64]),
    ("rnnt_pool_assemble", None, [_vp, _i, f32p, i32p, u8p]),
    ("rnnt_pool_commit", None, [_vp, _i, f32p, i32p]),
    ("rnnt_pool_assemble_tm", None, [_vp, _i, f32p, i32p, u8p]),
    ("rnnt_pool_commit_tm", None, [_vp, _i, f32p, i32p]),
    ("rnnt_pool_assemble_tm_i16", None, [_vp, _i, i16p, i32p, u8p]),
    ("rnnt_pool_commit_tm_i16", None, [_vp, _i, i16p, i32p]),
    # the strided forms of the fan-out: a pool of slots [off, off + n) of a
    # shared [T, total, 480] batch or [total, n] matrix, written in place
    ("rnnt_pool_assemble_tm_i16_strided", None,
     [_vp, _i, i16p, _i64, _i64, i32p, u8p]),
    ("rnnt_pool_commit_tm_i16_strided", None, [_vp, _i, i16p, _i64, _i64, i32p]),
    ("rnnt_pool_push_all_strided", _i, [_vp, i16p, _i64, _i64]),
    ("rnnt_pool_pull_all_strided", _i, [_vp, i16p, _i64, _i64]),
    ("rnnt_blob_validate", _i, [ct.c_char_p, _i64, ct.c_char_p, _i64]),
)


def bind(lib: ct.CDLL) -> ct.CDLL:
    """Declare the result and argument types of every entry point."""
    for name, res, args in SIGNATURES:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


class Pool:
    """A native pool of stream slots with int16 PCM rings (see streamio.cc)
    over a loaded library ``lib`` (``bind`` applied).  ``runtime.native.
    StreamPool`` builds the library itself; the fan-out's workers load one
    that their parent built."""

    def __init__(self, lib: ct.CDLL, n_slots: int, ring_frames: int = 64):
        self._p = None
        self._lib = lib
        self._p = lib.rnnt_pool_create(n_slots, ring_frames)
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

    def push_all(self, pcm: np.ndarray) -> int:
        """Bulk ingest [S, n] int16 into every active slot; returns the
        number of slots fed."""
        pcm = np.ascontiguousarray(pcm, np.int16)
        if pcm.ndim != 2 or pcm.shape[0] != self.n_slots:
            raise ValueError(f"pcm shape {pcm.shape}: want ({self.n_slots}, n)")
        return self._lib.rnnt_pool_push_all(self._p, pcm, pcm.shape[1])

    def pull_all(self, n: int, out: np.ndarray | None = None):
        """Drain up to n samples per slot -> ([S, n] int16 zero-filled,
        slots that produced a full n).  Pass ``out`` to reuse a buffer."""
        if out is None:
            out = np.empty((self.n_slots, n), np.int16)
        return out, self._lib.rnnt_pool_pull_all(self._p, out, n)

    def _buffers(self, shape, dtype, out):
        if out is None:
            return (np.empty(shape, dtype), np.empty(self.n_slots, np.int32),
                    np.empty(self.n_slots, np.uint8))
        if out[0].shape != shape or out[0].dtype != dtype:
            raise ValueError(f"batch {out[0].dtype} {out[0].shape}: want "
                             f"{np.dtype(dtype)} {shape}")
        return out

    def assemble(self, t_frames: int):
        """Stream-major f32 assembly: ([S, T, 480] f32, counts [S] int32,
        reset [S] uint8).  A slot gets all T frames or none."""
        batch, counts, reset = self._buffers(
            (self.n_slots, t_frames, FRAME), np.float32, None)
        self._lib.rnnt_pool_assemble(self._p, t_frames, batch, counts, reset)
        return batch, counts, reset

    def commit(self, t_frames: int, batch: np.ndarray,
               counts: np.ndarray) -> None:
        """Round [S, T, 480] f32 to int16 into the output rings."""
        self._lib.rnnt_pool_commit(
            self._p, t_frames, np.ascontiguousarray(batch, np.float32),
            np.ascontiguousarray(counts, np.int32))

    def assemble_tm(self, t_frames: int):
        """Time-major f32 assembly: [T, S, 480] (for process_frames_tm)."""
        batch, counts, reset = self._buffers(
            (t_frames, self.n_slots, FRAME), np.float32, None)
        self._lib.rnnt_pool_assemble_tm(self._p, t_frames, batch, counts,
                                        reset)
        return batch, counts, reset

    def commit_tm(self, t_frames: int, batch: np.ndarray,
                  counts: np.ndarray) -> None:
        self._lib.rnnt_pool_commit_tm(
            self._p, t_frames, np.ascontiguousarray(batch, np.float32),
            np.ascontiguousarray(counts, np.int32))

    def assemble_tm_i16(self, t_frames: int, out: tuple | None = None):
        """Time-major int16 assembly: ([T, S, 480] int16, counts [S] int32,
        reset [S] uint8).  Pass ``out=(batch, counts, reset)`` to reuse
        buffers across ticks (fresh ones re-fault their pages)."""
        batch, counts, reset = self._buffers(
            (t_frames, self.n_slots, FRAME), np.int16, out)
        self._lib.rnnt_pool_assemble_tm_i16(self._p, t_frames, batch, counts,
                                            reset)
        return batch, counts, reset

    def commit_tm_i16(self, t_frames: int, batch: np.ndarray,
                      counts: np.ndarray) -> None:
        self._lib.rnnt_pool_commit_tm_i16(
            self._p, t_frames, np.ascontiguousarray(batch, np.int16),
            np.ascontiguousarray(counts, np.int32))

    # -- the strided forms: this pool as slots [offset, offset + n_slots) of
    # shared tensors, written in place (the fan-out's workers) -------------
    def _check_shared(self, a: np.ndarray, axis: int, offset: int) -> None:
        if offset < 0 or offset + self.n_slots > a.shape[axis]:
            raise ValueError(f"slots [{offset}, {offset + self.n_slots}) out "
                             f"of the shared array's {a.shape[axis]}")

    def assemble_tm_i16_strided(self, t_frames: int, batch: np.ndarray,
                                offset: int, counts: np.ndarray,
                                reset: np.ndarray) -> None:
        """Assemble into slots [offset, offset + n) of ``batch`` [T', total,
        480] int16 (T' >= t_frames); ``counts`` and ``reset`` are this
        pool's own [n] slices."""
        self._check_shared(batch, 1, offset)
        self._lib.rnnt_pool_assemble_tm_i16_strided(
            self._p, t_frames, batch, batch.shape[1], offset, counts, reset)

    def commit_tm_i16_strided(self, t_frames: int, batch: np.ndarray,
                              offset: int, counts: np.ndarray) -> None:
        self._check_shared(batch, 1, offset)
        self._lib.rnnt_pool_commit_tm_i16_strided(
            self._p, t_frames, batch, batch.shape[1], offset, counts)

    def push_all_strided(self, pcm: np.ndarray, offset: int) -> int:
        """Ingest rows [offset, offset + n) of ``pcm`` [total, n] int16."""
        self._check_shared(pcm, 0, offset)
        return self._lib.rnnt_pool_push_all_strided(self._p, pcm,
                                                    pcm.shape[1], offset)

    def pull_all_strided(self, pcm: np.ndarray, offset: int) -> int:
        """Drain into rows [offset, offset + n) of ``pcm`` [total, n] int16
        (short reads zero-filled); returns the slots that filled a row."""
        self._check_shared(pcm, 0, offset)
        return self._lib.rnnt_pool_pull_all_strided(self._p, pcm,
                                                    pcm.shape[1], offset)

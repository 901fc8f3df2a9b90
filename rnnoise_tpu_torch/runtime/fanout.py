"""Multi-process host fan-out: K worker processes feed one device batch — the
counterpart of ``rnnoise_tpu/runtime/fanout.py``.

The global slot axis [0, S) is split into K contiguous ranges, each owned by
a worker process running its own native StreamPool (ring buffers and a
thread pool, ``native/streamio.cc``).  Assembly and commit write directly
into shared-memory ``[T, S, 480]`` int16 tensors through the strided native
entry points, so the parent never gathers or scatters per-worker results:
its part of a tick is the device step (``engine.advance``).

The workers are plain subprocesses running ``fanout_worker.py`` by path,
with only numpy and ctypes: K copies of torch would cost each host core
seconds of import and hundreds of MB for nothing.  Each speaks
``multiprocessing.connection``'s length-prefixed pickle over one end of a
unix socket pair that the parent passes by descriptor.  The parent builds
``streamio.cc`` once into a fresh file in ``_build/``, which every worker
loads and which is unlinked once they all have.  The parent owns the shared
segments; ``close()``, or the finalizer at interpreter exit, stops the
workers and unlinks them.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import uuid
import weakref
from multiprocessing import shared_memory
from multiprocessing.connection import Connection
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..config import DEFAULT_RUNTIME, RuntimeConfig
from . import streamio_abi
from .engine import SlotEngine

FRAME = 480
WORKER_PY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fanout_worker.py")
REPLY_TIMEOUT_S = 120.0


def _build_streamio() -> str:
    """streamio.cc built into a fresh file of its own in ``_build/``."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    out = os.path.join(kernels.BUILD_DIR, f"libstreamio-fanout-{os.getpid()}-"
                                          f"{uuid.uuid4().hex}.so")
    res = subprocess.run([*streamio_abi.BUILD_ARGV, "-o", out],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"streamio build failed:\n{res.stdout}{res.stderr}")
    return out


def _release(procs: list, conns: list, shms: dict) -> None:
    """Stop the workers, close the sockets, unlink the shared segments."""
    for c in conns:
        try:
            c.send(("stop", None))
        except OSError:
            pass
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for c in conns:
        c.close()
    for s in shms.values():
        s.close()
        try:
            s.unlink()
        except FileNotFoundError:
            pass
    procs.clear()
    conns.clear()
    shms.clear()


class FanoutPool:
    """Bulk-mode StreamPool whose push, pull, assemble and commit run across
    ``n_workers`` processes, each on its contiguous range of slots.

    Bulk interface: attach_all / detach / push_all / pull_all /
    assemble_tm_i16 / commit_tm_i16; per-slot push and pull belong to an
    ingest front end that owns a worker's range."""

    def __init__(self, n_slots: int, n_workers: int,
                 ring_frames: int = 256, t_max: int = 16,
                 io_cap_frames: int = 64):
        if n_workers < 1 or n_slots % n_workers:
            raise ValueError(f"n_slots {n_slots} is not split evenly over "
                             f"{n_workers} workers")
        self.n_slots = n_slots
        self.n_workers = n_workers
        self.per = n_slots // n_workers
        self.t_max = t_max
        self.io_cap = io_cap_frames * FRAME
        self._procs, self._conns, self._shms = [], [], {}
        self._finalizer = weakref.finalize(self, _release, self._procs,
                                           self._conns, self._shms)
        try:
            self._start(ring_frames)
        except BaseException:
            self.close()
            raise

    def _start(self, ring_frames: int) -> None:
        S, t_max = self.n_slots, self.t_max
        tm_bytes = 2 * t_max * S * FRAME
        for name, size in (("in", tm_bytes), ("out", tm_bytes),
                           ("counts", 4 * S), ("reset", S),
                           ("io", 2 * S * self.io_cap)):
            self._shms[name] = shared_memory.SharedMemory(create=True,
                                                          size=size)
        buf = {k: s.buf for k, s in self._shms.items()}
        self.in_batch = np.ndarray((t_max, S, FRAME), np.int16, buf["in"])
        self.out_batch = np.ndarray((t_max, S, FRAME), np.int16, buf["out"])
        self.counts = np.ndarray((S,), np.int32, buf["counts"])
        self.reset = np.ndarray((S,), np.uint8, buf["reset"])
        self._io = np.ndarray((S * self.io_cap,), np.int16, buf["io"])
        names = {k: s.name for k, s in self._shms.items()}
        lib = _build_streamio()
        try:
            for w in range(self.n_workers):
                mine, theirs = socket.socketpair()
                cfg = {"lib": lib, "fd": theirs.fileno(), "n_local": self.per,
                       "slot_offset": w * self.per, "total_slots": S,
                       "ring_frames": ring_frames, "shm_names": names,
                       "t_max": t_max, "io_cap": self.io_cap}
                with mine, theirs:
                    self._procs.append(subprocess.Popen(
                        [sys.executable, WORKER_PY, json.dumps(cfg)],
                        stdin=subprocess.DEVNULL, pass_fds=(theirs.fileno(),)))
                    self._conns.append(Connection(mine.detach()))
            self._replies()                 # every worker has loaded lib
        finally:
            os.unlink(lib)

    # -- command fan-out ---------------------------------------------------
    def _reply(self, w: int):
        c = self._conns[w]
        if not c.poll(REPLY_TIMEOUT_S):
            raise RuntimeError(f"fan-out worker {w} gave no reply in "
                               f"{REPLY_TIMEOUT_S} s")
        try:
            status, val = c.recv()
        except EOFError:
            raise RuntimeError(f"fan-out worker {w} exited (code "
                               f"{self._procs[w].poll()})") from None
        if status != "ok":
            raise RuntimeError(f"fan-out worker {w} failed: {val}")
        return val

    def _replies(self) -> list:
        return [self._reply(w) for w in range(len(self._conns))]

    def _all(self, op: str, arg=None) -> list:
        for c in self._conns:
            c.send((op, arg))
        return self._replies()

    def _io_view(self, n: int) -> np.ndarray:
        if not 0 < n <= self.io_cap:
            raise ValueError(f"{n} samples a slot: the shared io region holds "
                             f"{self.io_cap}")
        return self._io[:self.n_slots * n].reshape(self.n_slots, n)

    # -- bulk stream management --------------------------------------------
    def attach_all(self) -> int:
        """Attach every free slot; returns how many were attached."""
        return sum(self._all("attach", self.per))

    def detach(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} of {self.n_slots}")
        w, local = divmod(slot, self.per)
        self._conns[w].send(("detach", local))
        self._reply(w)

    def push_all(self, pcm: np.ndarray) -> int:
        """Bulk ingest [S, n] int16 into every active slot; returns the
        number of slots fed."""
        if pcm.ndim != 2 or pcm.shape[0] != self.n_slots:
            raise ValueError(f"pcm shape {pcm.shape}: want ({self.n_slots}, n)")
        np.copyto(self._io_view(pcm.shape[1]), pcm, casting="same_kind")
        return sum(self._all("push", pcm.shape[1]))

    def pull_all(self, n: int, out: Optional[np.ndarray] = None):
        """Drain up to n samples per slot -> ([S, n] int16 zero-filled,
        slots that produced a full n).  Pass ``out`` to reuse a buffer."""
        view = self._io_view(n)
        full = sum(self._all("pull", n))
        if out is None:
            return view.copy(), full
        np.copyto(out, view)
        return out, full

    def assemble_tm_i16(self, t_frames: int):
        """Parallel time-major assembly into the shared in_batch; returns
        views (valid until the next assemble)."""
        if not 0 < t_frames <= self.t_max:
            raise ValueError(f"t_frames {t_frames} of at most {self.t_max}")
        self._all("assemble", t_frames)
        return self.in_batch[:t_frames], self.counts, self.reset

    def commit_tm_i16(self, t_frames: int, batch: np.ndarray,
                      counts: Optional[np.ndarray] = None) -> None:
        """Commit ``batch`` [T, S, 480] int16 (copied into the shared out
        tensor unless it is that tensor already) in parallel.  ``counts``
        defaults to the shared counts of the matching assemble."""
        if not 0 < t_frames <= self.t_max:
            raise ValueError(f"t_frames {t_frames} of at most {self.t_max}")
        dst = self.out_batch[:t_frames]
        if not (batch.ctypes.data == dst.ctypes.data and batch.shape == dst.shape):
            np.copyto(dst, batch, casting="same_kind")
        if counts is not None and counts is not self.counts:
            np.copyto(self.counts, counts)
        self._all("commit", t_frames)

    def close(self) -> None:
        """Stop the workers and free the shared memory (idempotent).  The
        views of the segments go first: a write through one after the
        unmapping would fault."""
        self.in_batch = self.out_batch = self.counts = self.reset = None
        self._io = None
        self._finalizer()


class FanoutEngine(SlotEngine):
    """StreamingEngine with the host side fanned out over ``n_workers``
    processes: the same device tick (``engine.advance``: reset, int16
    time-major chunk, starvation rollback).  ``pipelined=True`` commits the
    previous tick's output while the device computes the current one.
    ``device`` defaults to the model's, else CUDA."""

    def __init__(self, n_slots: int, model=None, chunk_frames: int = 8,
                 n_workers: int = 2,
                 runtime: RuntimeConfig = DEFAULT_RUNTIME,
                 ring_frames: int = 256, pipelined: bool = False,
                 device=None):
        super().__init__(n_slots, model, chunk_frames, runtime, pipelined,
                         device)
        self.pool = FanoutPool(n_slots, n_workers, ring_frames=ring_frames,
                               t_max=max(chunk_frames, 1))

    def attach_all(self) -> int:
        return self.pool.attach_all()

    def detach(self, slot: int) -> None:
        self.pool.detach(slot)

    def push_all(self, pcm_i16: np.ndarray) -> int:
        return self.pool.push_all(pcm_i16)

    def pull_all(self, n: int, out: Optional[np.ndarray] = None):
        return self.pool.pull_all(n, out)

    def close(self) -> None:
        self.pool.close()

    # -- the tick's host stages ----------------------------------------------
    def _assemble(self, T: int):
        batch, counts, reset = self.pool.assemble_tm_i16(T)
        # the shared counts change at the next assemble
        return batch, counts.copy(), reset

    def _to_host(self, out: torch.Tensor) -> np.ndarray:
        # straight into the shared out tensor that the workers commit from
        dst = self.pool.out_batch[:out.shape[0]]
        torch.from_numpy(dst).copy_(out)
        return dst

    def _commit(self, T: int, out: np.ndarray, counts: np.ndarray) -> None:
        self.pool.commit_tm_i16(T, out, counts)

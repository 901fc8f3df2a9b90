"""Streaming engine: native stream pool + batched device compute — the
counterpart of ``rnnoise_tpu/runtime/engine.py``.

Streams attach to and detach from fixed batch slots; each tick the native
pool assembles a time-major ``[T, S, 480]`` int16 chunk, the device advances
every slot with ``process_frames_tm_i16``, and the results go back into the
per-stream output rings.  A slot that had no full chunk this tick (starved
or inactive) is processed on zeros and then rolled back, so its state never
advances; a freshly attached slot is reset first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..api import RNNoise
from ..config import DEFAULT_MODEL, DEFAULT_RUNTIME, RuntimeConfig, resolve_device
from ..denoise import init_state, map_state, process_frames_tm_i16, reset_streams
from .native import StreamPool


def advance(params, state, pcm, counts, reset, runtime=DEFAULT_RUNTIME):
    """One device tick of a stream-slot engine: zero the slots flagged in
    ``reset`` [S] (freshly attached), advance every slot by the int16 chunk
    ``pcm`` [T, S, 480] with ``process_frames_tm_i16``, and keep the old
    state of the slots whose ``counts`` [S] show no full chunk (starved or
    inactive: their zero frames must not advance it).  Returns (state,
    out [T, S, 480] int16)."""
    state = reset_streams(state, reset)
    new, out, _ = process_frames_tm_i16(params, state, pcm, runtime)
    full = counts >= pcm.shape[0]
    state = map_state(
        lambda n, o: torch.where(
            full.reshape((-1,) + (1,) * (n.ndim - 1)), n, o), new, state)
    return state, out


class SlotEngine:
    """The tick shared by ``StreamingEngine`` and ``fanout.FanoutEngine``.

    A tick runs five stages, each its own method so that they can be timed
    one at a time: ``_assemble`` (host: the pool fills the chunk),
    ``_to_device``, ``_compute`` (``advance``), ``_to_host`` and ``_commit``
    (host: the pool takes the output).  ``pipelined=True`` commits the
    PREVIOUS tick's output while the device computes the current one (one
    chunk of extra latency); call flush() to drain the last chunk.  A
    subclass provides ``_assemble(T) -> (batch, counts, reset)`` (numpy;
    ``counts`` its own copy, which the next assemble leaves alone) and
    ``_commit(T, out, counts)``."""

    def __init__(self, n_slots: int, model: Optional[RNNoise],
                 chunk_frames: int, runtime: RuntimeConfig, pipelined: bool,
                 device):
        if device is None:
            device = model.device if model is not None else "cuda"
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.chunk_frames = chunk_frames
        self.pipelined = pipelined
        self.runtime = runtime
        self._pending = None        # (host out, ready event, counts)
        config = model.config if model is not None else DEFAULT_MODEL
        self.params = model.params if model is not None else None
        self.state = init_state(n_slots, config, self.device)

    def _to_device(self, batch, counts, reset):
        dev = self.device
        return (torch.from_numpy(batch).to(dev),
                torch.from_numpy(counts).to(dev),
                torch.from_numpy(reset).to(dev, torch.bool))

    def _compute(self, pcm, counts, reset) -> torch.Tensor:
        self.state, out = advance(self.params, self.state, pcm, counts, reset,
                                  self.runtime)
        return out

    def _to_host(self, out: torch.Tensor) -> np.ndarray:
        return out.cpu().numpy()

    def tick(self) -> int:
        """Assemble one chunk, process it on the device, commit the results.

        Returns the number of streams that advanced (in pipelined mode: whose
        previous chunk was committed).  Streams advance in whole
        chunk_frames quanta."""
        T = self.chunk_frames
        batch, counts, reset = self._assemble(T)
        out = self._compute(*self._to_device(batch, counts, reset))
        if not self.pipelined:
            self._commit(T, self._to_host(out), counts)
            return int((counts >= T).sum())
        ready = None
        if out.is_cuda:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host = out
        advanced = self.flush()
        self._pending = (host, ready, counts)
        return advanced

    def flush(self) -> int:
        """Commit the pending pipelined chunk (no-op when none is pending)."""
        if self._pending is None:
            return 0
        host, ready, counts = self._pending
        self._pending = None
        if ready is not None:
            ready.synchronize()
        self._commit(self.chunk_frames, host.numpy(), counts)
        return int((counts >= self.chunk_frames).sum())


class StreamingEngine(SlotEngine):
    def __init__(self, n_slots: int, model: Optional[RNNoise] = None,
                 chunk_frames: int = 8,
                 runtime: RuntimeConfig = DEFAULT_RUNTIME,
                 ring_frames: int = 256, pipelined: bool = False,
                 device=None):
        """One process's native pool feeds the device.  ``device`` defaults
        to the model's, else CUDA."""
        super().__init__(n_slots, model, chunk_frames, runtime, pipelined,
                         device)
        self.pool = StreamPool(n_slots, ring_frames)
        # reused host assembly buffers (fresh ones re-fault their pages)
        self._bufs = (np.empty((chunk_frames, n_slots, 480), np.int16),
                      np.empty(n_slots, np.int32), np.empty(n_slots, np.uint8))

    # -- stream management -------------------------------------------------
    def attach(self) -> int:
        """Add a stream; returns its slot id (or -1 if the pool is full)."""
        return self.pool.attach()

    def detach(self, slot: int) -> None:
        self.pool.detach(slot)

    def push(self, slot: int, pcm_i16: np.ndarray) -> int:
        return self.pool.push(slot, pcm_i16)

    def pull(self, slot: int, n: int) -> np.ndarray:
        return self.pool.pull(slot, n)

    def available(self, slot: int) -> int:
        return self.pool.available(slot)

    # -- the tick's host stages ----------------------------------------------
    def _assemble(self, T: int):
        batch, counts, reset = self.pool.assemble_tm_i16(T, out=self._bufs)
        return batch, counts.copy(), reset

    def _commit(self, T: int, out: np.ndarray, counts: np.ndarray) -> None:
        self.pool.commit_tm_i16(T, out, counts)

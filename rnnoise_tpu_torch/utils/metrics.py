"""Observability helpers — the counterpart of ``rnnoise_tpu/utils/metrics.py``.

  * ThroughputMeter — frames a second and realtime streams around the
    batched step (the caller synchronises the device before ``stop``)
  * gain_mse — the per-band gain MSE against a reference run
  * profile_trace — ``torch.profiler`` around a block, the card's kernels
    included when there is one, written as a Chrome trace into ``log_dir``
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import FRAME_SIZE

SAMPLE_RATE = 48000.0


@dataclass
class ThroughputMeter:
    frames: int = 0
    streams: int = 0
    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_streams: int, n_frames: int):
        self.seconds += time.perf_counter() - self._t0
        self.frames += n_frames * n_streams
        self.streams = n_streams

    @property
    def frames_per_sec(self) -> float:
        return self.frames / max(self.seconds, 1e-12)

    @property
    def realtime_streams(self) -> float:
        """Seconds of audio processed per second of wall time."""
        return self.frames * FRAME_SIZE / SAMPLE_RATE / max(self.seconds, 1e-12)

    def summary(self) -> dict:
        return dict(frames_per_sec=self.frames_per_sec,
                    realtime_streams=self.realtime_streams,
                    wall_seconds=self.seconds)


def gain_mse(gains, gains_ref) -> float:
    """Per-band gain MSE against a reference run."""
    return float(np.mean((np.asarray(gains, np.float64)
                          - np.asarray(gains_ref, np.float64)) ** 2))


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block (host operators, and the card's kernels when CUDA
    is available) and write ``log_dir/trace-<pid>.json``; yields the
    profiler, whose ``key_averages()`` sums the time by operator."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))

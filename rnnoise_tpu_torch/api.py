"""Public API, mirroring include/rnnoise.h:57-125 — the counterpart of
``rnnoise_tpu/api.py``.

  rnnoise_get_frame_size        -> get_frame_size() / StreamDenoiser.frame_size
  rnnoise_create/init/destroy   -> StreamDenoiser(n_streams, model) / .reset()
  rnnoise_process_frame         -> StreamDenoiser.process_frame (S frames)
  rnnoise_model_from_buffer     -> RNNoise.from_buffer
  rnnoise_model_from_file(name) -> RNNoise.from_file / from_filename
"""

from __future__ import annotations

from typing import IO, Optional

import numpy as np
import torch

from .config import (DEFAULT_MODEL, DEFAULT_RUNTIME, FRAME_SIZE, ModelConfig,
                     RuntimeConfig, resolve_device)
from .denoise import DenoiseState, init_state, process_frame, process_frames
from .models.rnn import ModelParams
from .weights.blob import parse_weights
from .weights.loader import infer_model_config, model_params_from_arrays


def get_frame_size() -> int:
    """rnnoise_get_frame_size (include/rnnoise.h:77-81)."""
    return FRAME_SIZE


class RNNoise:
    """A loaded model (reference RNNModel, denoise.c:227-275) on a device."""

    def __init__(self, params: ModelParams,
                 config: ModelConfig = DEFAULT_MODEL, device="cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.config = config

    @classmethod
    def from_buffer(cls, blob: bytes, config: Optional[ModelConfig] = None,
                    device="cuda") -> "RNNoise":
        """config=None infers the topology from the blob."""
        arrays = parse_weights(blob)
        if config is None:
            config = infer_model_config(arrays)
        device = resolve_device(device)
        return cls(model_params_from_arrays(arrays, config, device), config,
                   device)

    @classmethod
    def from_file(cls, f: IO[bytes], config: Optional[ModelConfig] = None,
                  device="cuda") -> "RNNoise":
        return cls.from_buffer(f.read(), config, device)

    @classmethod
    def from_filename(cls, path: str, config: Optional[ModelConfig] = None,
                      device="cuda") -> "RNNoise":
        with open(path, "rb") as f:
            return cls.from_file(f, config, device)


class StreamDenoiser:
    """S concurrent streaming denoisers on one device; with S == 1 it
    behaves like one reference DenoiseState."""

    frame_size = FRAME_SIZE

    def __init__(self, n_streams: int = 1, model: Optional[RNNoise] = None,
                 runtime: RuntimeConfig = DEFAULT_RUNTIME, device=None):
        """``device`` defaults to the model's, else CUDA."""
        if device is None:
            device = model.device if model is not None else "cuda"
        self.device = resolve_device(device)
        self.n_streams = n_streams
        self.model = model
        self.runtime = runtime
        self.params = model.params if model is not None else None
        self.reset()

    def reset(self) -> None:
        """rnnoise_init equivalent: zero all stream states."""
        config = self.model.config if self.model is not None else DEFAULT_MODEL
        self.state: DenoiseState = init_state(self.n_streams, config,
                                              self.device)

    def process_frame(self, pcm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """pcm: [S, FRAME_SIZE] (or [FRAME_SIZE] when S == 1) float PCM in
        int16 scale.  Returns (denoised [S, FRAME_SIZE], vad [S])."""
        x = torch.as_tensor(np.asarray(pcm, np.float32).reshape(
            self.n_streams, FRAME_SIZE)).to(self.device)
        self.state, out, vad = process_frame(self.params, self.state, x,
                                             self.runtime)
        return out.cpu().numpy(), vad.cpu().numpy()

    def process_chunk(self, pcm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """pcm: [S, T, FRAME_SIZE] — T frames per stream in one call."""
        x = torch.as_tensor(np.asarray(pcm, np.float32)).to(self.device)
        self.state, out, vad = process_frames(self.params, self.state, x,
                                              self.runtime)
        return out.cpu().numpy(), vad.cpu().numpy()

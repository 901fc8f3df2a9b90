"""rnnoise_tpu_torch — the stream-batched RNNoise denoiser in PyTorch and CUDA.

The PyTorch/CUDA port of ``rnnoise_tpu``: the same batched streaming
denoiser, weight-blob reader and model registry, serving engine and its
multi-process fan-out, C ABI and demo, stream sharding across devices and
training stack (``training/``, ``tools/``), with hand-written CUDA kernels
(``csrc/``) carrying the frame.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors every kernel wrapper uses its plain PyTorch version.
"""

from .api import RNNoise, StreamDenoiser  # noqa: F401
from .config import (DEFAULT_MODEL, DEFAULT_RUNTIME, FRAME_SIZE,  # noqa: F401
                     ModelConfig, NB_BANDS, NB_FEATURES, RuntimeConfig)
from .denoise import (DenoiseState, init_state, process_frame,  # noqa: F401
                      process_frames, process_frames_tm,
                      process_frames_tm_i16)
from .models.rnn import ModelParams, RNNState  # noqa: F401

__version__ = "0.1.0"

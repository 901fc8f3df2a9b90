"""Frame, band and pitch constants and the model/runtime configuration.

A copy of ``rnnoise_tpu/config.py`` (reference src/denoise.h:31-41) so that
this package never imports the JAX one, plus the device and precision
settings every entry point applies.
"""

from __future__ import annotations

import dataclasses

import torch

FRAME_SIZE = 480            # 10 ms @ 48 kHz
WINDOW_SIZE = 2 * FRAME_SIZE
FREQ_SIZE = FRAME_SIZE + 1  # 481 rFFT bins kept
NB_BANDS = 32
NB_FEATURES = 2 * NB_BANDS + 1   # 65

PITCH_MIN_PERIOD = 60
PITCH_MAX_PERIOD = 768
PITCH_FRAME_SIZE = 960
PITCH_BUF_SIZE = PITCH_MAX_PERIOD + PITCH_FRAME_SIZE  # 1728

SILENCE_THRESHOLD = 0.04    # reference src/denoise.c:389


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Topology of the gain/VAD RNN (reference torch/rnnoise/rnnoise.py:58-72)."""

    input_dim: int = NB_FEATURES     # 65
    output_dim: int = NB_BANDS       # 32
    cond_size: int = 128
    gru_size: int = 384
    conv_kernel: int = 3

    @property
    def cat_size(self) -> int:
        # concat of [conv2_out, gru1, gru2, gru3] (reference src/rnn.c:46, 53-55)
        return 4 * self.gru_size


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Numerics options (reference src/vec.h:39-43, src/nnet_arch.h:77).

    * ``quantized``  – int8 weights with quantised activations vs float weights.
    * ``approx_act`` – rational tanh/sigmoid approximations vs torch's own.

    On CUDA only the default (quantized, approx_act) has a kernel.
    """

    quantized: bool = True
    approx_act: bool = True


DEFAULT_MODEL = ModelConfig()
DEFAULT_RUNTIME = RuntimeConfig()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Turns off TF32 for CUDA work, since pitch ranking and the
    silence gate sit on knife edges that a 10-bit mantissa moves."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device

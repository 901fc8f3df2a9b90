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


HP_ROUNDINGS = ("f64", "xla_cpu")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Numerics options (reference src/vec.h:39-43, src/nnet_arch.h:77) and
    the kernels that carry the frame.

    * ``quantized``  – int8 weights with quantised activations vs float weights.
    * ``approx_act`` – rational tanh/sigmoid approximations vs torch's own.
    * ``exact_pitch_rank`` – rank pitch candidates with find_best_pitch's
      sequential cross-multiplied comparisons (src/pitch.c:44-102) instead
      of the vectorised ratio ranking; a parity tool, one PyTorch step per
      lag.  It runs the pitch chain in PyTorch (no analysis kernel).
    * ``hp_rounding`` – how the HP biquad's [S, 2] state is rounded at each
      frame's end (``dsp/biquad.py``): "f64" (serving) or "xla_cpu" (as the
      JAX package's CPU graph rounds it, for holding the port against it).
    * ``analysis``   – the fused pitch-analysis kernel (fine search, doubling
      ladder, window and both forward spectra in one launch;
      ``dsp/cuda_analysis.py``) in place of the pitch chain and the
      forward-spectrum kernel: the counterpart of the JAX package's
      ``pallas_analysis.set_analysis``.
    * ``postfilter`` – the fused post-filter and synthesis kernel
      (``cuda_spectral.postfilter_synthesis``) in place of the comb filter's
      operators and the inverse-spectrum kernel: ``pallas_spectral.set_postfilter``.
    * ``xcorr``      – the lag-correlation kernel (``dsp/cuda_xcorr.py``) for
      the pitch chain's lag table, when ``analysis`` is off:
      ``pitch._XCORR_PALLAS``.
    * ``monokernel`` – the int16 chunk entry point (``process_frames_tm_i16``)
      runs the whole chunk as one kernel launch (``dsp/cuda_frame.py``), the
      counterpart of ``denoise.set_monokernel``; it overrides the three
      switches above.  It has the default numerics, the ratio ranking and
      the "f64" HP rounding only, and raises on CUDA tensors otherwise.
      Without a model or with a float-only one (no int8 weights) the chunk
      runs the fused configuration, as the JAX package falls back; so do
      the float entry points.

    The fields' defaults are the fused configuration.  ``DEFAULT_RUNTIME``,
    which the entry points take when given none, is the configuration that
    keeps the most streams in real time on an H100 ("mono", PERF.md), as
    the JAX package's default is the one measured best on a TPU.  The
    kernels have the default numerics only; the others run as plain
    PyTorch on any device.
    """

    quantized: bool = True
    approx_act: bool = True
    exact_pitch_rank: bool = False
    hp_rounding: str = "f64"
    analysis: bool = True
    postfilter: bool = True
    xcorr: bool = False
    monokernel: bool = False

    def __post_init__(self):
        if self.hp_rounding not in HP_ROUNDINGS:
            raise ValueError(f"hp_rounding must be one of {HP_ROUNDINGS}, "
                             f"not {self.hp_rounding!r}")


# The kernel configurations of the main path: "scan" runs the RNN step and
# the forward and inverse spectra as kernels, "xcorr" adds the lag table,
# "fused" runs the analysis, the RNN step and the post-filter, "mono" runs
# the whole chunk in one kernel.
CONFIGURATIONS = {
    "scan": RuntimeConfig(analysis=False, postfilter=False),
    "xcorr": RuntimeConfig(analysis=False, postfilter=False, xcorr=True),
    "fused": RuntimeConfig(),
    "mono": RuntimeConfig(monokernel=True),
}

DEFAULT_MODEL = ModelConfig()
DEFAULT_RUNTIME = CONFIGURATIONS["mono"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Turns off TF32 for CUDA work, since pitch ranking and the
    silence gate sit on knife edges that a 10-bit mantissa moves."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device

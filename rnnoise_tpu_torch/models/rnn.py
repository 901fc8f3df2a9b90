"""The RNNoise model graph: conv1 -> conv2 -> 3x GRU -> gain/VAD heads.

Replicates compute_rnn (reference src/rnn.c:44-60) over a stream batch —
the PyTorch counterpart of ``rnnoise_tpu/models/rnn.py``.  On the default
numerics (int8 weights, rational activations) the step runs as one CUDA
kernel for CUDA tensors (``nn/cuda_rnn.py``); this module holds the layer
graph that is its plain version and the float-weight and exact-activation
paths, which run as plain PyTorch on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import DEFAULT_MODEL, DEFAULT_RUNTIME, ModelConfig, RuntimeConfig
from ..nn.layers import LinearParams, conv1d_step, dense, gru_step


class ModelParams(NamedTuple):
    conv1: LinearParams
    conv2: LinearParams
    gru1_input: LinearParams
    gru1_recurrent: LinearParams
    gru2_input: LinearParams
    gru2_recurrent: LinearParams
    gru3_input: LinearParams
    gru3_recurrent: LinearParams
    dense_out: LinearParams
    vad_dense: LinearParams


class RNNState(NamedTuple):
    """Batched equivalent of the reference RNNState (src/rnn.h:40-46)."""

    conv1_mem: torch.Tensor     # [S, (k-1) * input_dim]
    conv2_mem: torch.Tensor     # [S, (k-1) * cond_size]
    gru1: torch.Tensor          # [S, gru_size]
    gru2: torch.Tensor
    gru3: torch.Tensor


def init_rnn_state(n_streams: int, config: ModelConfig = DEFAULT_MODEL,
                   device="cuda") -> RNNState:
    k = config.conv_kernel - 1

    def z(width):
        return torch.zeros((n_streams, width), dtype=torch.float32,
                           device=device)
    return RNNState(conv1_mem=z(k * config.input_dim),
                    conv2_mem=z(k * config.cond_size),
                    gru1=z(config.gru_size), gru2=z(config.gru_size),
                    gru3=z(config.gru_size))


def compute_rnn_layers(params: ModelParams, state: RNNState,
                       features: torch.Tensor, quantized: bool, approx: bool,
                       silence: Optional[torch.Tensor] = None):
    """The layer-by-layer graph.  features: [S, NB_FEATURES] ->
    (new_state, gains[S, 32], vad[S]).  ``silence`` [S] bool rows keep their
    old state and get VAD 0 (denoise.c:474-480); their gains are still
    computed (the caller blends them away)."""
    conv1_mem, c1 = conv1d_step(params.conv1, state.conv1_mem, features,
                                "tanh", False, approx)    # conv1 is never int8
    conv2_mem, c2 = conv1d_step(params.conv2, state.conv2_mem, c1,
                                "tanh", quantized, approx)
    g1 = gru_step(params.gru1_input, params.gru1_recurrent, state.gru1, c2,
                  quantized, approx)
    g2 = gru_step(params.gru2_input, params.gru2_recurrent, state.gru2, g1,
                  quantized, approx)
    g3 = gru_step(params.gru3_input, params.gru3_recurrent, state.gru3, g2,
                  quantized, approx)
    cat = torch.cat([c2, g1, g2, g3], dim=-1)
    gains = dense(params.dense_out, cat, "sigmoid", False, approx)
    vad = dense(params.vad_dense, cat, "sigmoid", False, approx)[:, 0]
    new_state = RNNState(conv1_mem, conv2_mem, g1, g2, g3)
    if silence is not None:
        keep = silence[:, None]
        new_state = RNNState(*(torch.where(keep, old, new)
                               for new, old in zip(new_state, state)))
        vad = torch.where(silence, torch.zeros_like(vad), vad)
    return new_state, gains, vad


def compute_rnn(params: ModelParams, state: RNNState, features: torch.Tensor,
                rt: RuntimeConfig = DEFAULT_RUNTIME,
                silence: Optional[torch.Tensor] = None, plain: bool = False):
    """features: [S, NB_FEATURES] -> (new_state, gains[S, 32], vad[S]).

    The default numerics go through the RNN-step kernel wrapper
    (``nn.cuda_rnn.compute_rnn_step``), or its plain version when
    ``plain`` is set.  The float-weight and exact-activation variants have
    no kernel and run as the plain layer graph on any device."""
    if rt.quantized and rt.approx_act and params.conv2.weights_q is not None:
        from ..nn import cuda_rnn
        step = cuda_rnn.compute_rnn_plain if plain else cuda_rnn.compute_rnn_step
        return step(params, state, features, silence)
    return compute_rnn_layers(params, state, features, rt.quantized,
                              rt.approx_act, silence)

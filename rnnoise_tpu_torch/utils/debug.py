"""Debugging aids — the counterpart of ``rnnoise_tpu/utils/debug.py``.

  * ``debug_nans()`` — a context manager with autograd's anomaly detection
    on, so that training code raises at the backward operation that first
    makes a NaN (the JAX package turns on ``jax_debug_nans``).
  * ``checked_process_frames`` — ``process_frames`` with every output and
    state leaf checked for NaN and Inf after each frame.
  * ``numerics_ab`` — both numerics (int8 and float weights) on one input:
    the runtime analogue of the reference's --enable-dnn-debug-float A/B
    (configure.ac:81-87).
"""

from __future__ import annotations

import contextlib

import torch

from ..config import DEFAULT_MODEL, ModelConfig, RuntimeConfig
from ..denoise import DenoiseState, init_state, process_frames
from ..models.rnn import RNNState


@contextlib.contextmanager
def debug_nans():
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def _named_leaves(state: DenoiseState):
    for name, t in zip(state._fields, state):
        if isinstance(t, RNNState):
            yield from ((f"rnn.{n}", u) for n, u in zip(t._fields, t))
        else:
            yield name, t


def checked_process_frames(params, state: DenoiseState, pcm: torch.Tensor,
                           rt: RuntimeConfig = RuntimeConfig()):
    """``process_frames`` (pcm [S, T, 480]) that raises FloatingPointError
    naming the first leaf and frame with a NaN or an Inf.

    JAX's ``checkify.float_checks`` stops at the first operation that makes
    one; the port cannot look inside its kernels, so this steps the frames
    one at a time (the float entry points run a frame loop, and one frame
    at a time gives the same results) and checks the output, the VAD and
    every state leaf after each frame."""
    outs, vads = [], []
    for t in range(pcm.shape[1]):
        state, out, vad = process_frames(params, state, pcm[:, t:t + 1], rt)
        for name, leaf in (("out", out), ("vad", vad), *_named_leaves(state)):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError(f"non-finite {name} at frame {t}")
        outs.append(out)
        vads.append(vad)
    return state, torch.cat(outs, dim=1), torch.cat(vads, dim=1)


def numerics_ab(params, pcm: torch.Tensor, rt_a=None, rt_b=None):
    """The largest VAD and PCM differences between the int8 (``rt_a``) and
    float-weight (``rt_b``) numerics over a chunk pcm [S, T, 480], each from
    a fresh state on pcm's device.  Returns (max_vad_delta, max_pcm_delta)."""
    rt_a = rt_a or RuntimeConfig(quantized=True)
    rt_b = rt_b or RuntimeConfig(quantized=False)
    config = DEFAULT_MODEL if params is None else ModelConfig(
        cond_size=params.conv1.bias.shape[0], gru_size=params.conv2.bias.shape[0])
    S = pcm.shape[0]
    _, out_a, vad_a = process_frames(
        params, init_state(S, config, pcm.device), pcm, rt_a)
    _, out_b, vad_b = process_frames(
        params, init_state(S, config, pcm.device), pcm, rt_b)
    return (float((vad_a - vad_b).abs().max()),
            float((out_a - out_b).abs().max()))

"""The RNN step as one CUDA kernel (``csrc/rnn_step.cu``) — the port of
``rnnoise_tpu/nn/pallas_rnn.py:compute_rnn_pallas``.

``compute_rnn_step`` launches the kernel for CUDA tensors and uses the plain
version, :func:`compute_rnn_plain` (the layer graph of ``models/rnn.py`` on
the int8 / approx-activation numerics), for CPU tensors.  The kernel reads
the weights in its own layout (:class:`PackedRNN`), packed once per model.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..models.rnn import ModelParams, RNNState, compute_rnn_layers


class PackedRNN(NamedTuple):
    """Kernel weight layout.  int8 matrices [in, out] become int32 words
    [in/4, out] holding rows 4w..4w+3 of one column (byte t = row 4w+t), the
    operand layout of __dp4a."""

    conv1_w: torch.Tensor        # [3F, C] f32
    conv1_b: torch.Tensor        # [C]
    conv2_w: torch.Tensor        # [3C/4, N] int32
    conv2_scale: torch.Tensor    # [N]
    conv2_b: torch.Tensor        # [N]
    gru_in_w: torch.Tensor       # [3, N/4, 3N] int32
    gru_in_scale: torch.Tensor   # [3, 3N]
    gru_in_b: torch.Tensor       # [3, 3N]
    gru_rec_w: torch.Tensor      # [3, N/4, 3N] int32
    gru_rec_scale: torch.Tensor  # [3, 3N]
    gru_rec_b: torch.Tensor      # [3, 3N]
    gru_diag: torch.Tensor       # [3, 3N]
    heads_w: torch.Tensor        # [NB+1, 4N] f32: gains rows, then VAD
    heads_b: torch.Tensor        # [NB+1]


def pack_int8(wq: torch.Tensor) -> torch.Tensor:
    """[in, out] int8 -> [in/4, out] int32 with four input rows per word."""
    n_in, n_out = wq.shape
    if n_in % 4:
        raise ValueError(f"int8 layer input width {n_in} is not a multiple of 4")
    return (wq.reshape(n_in // 4, 4, n_out).permute(0, 2, 1).contiguous()
            .view(torch.int32).reshape(n_in // 4, n_out))


def pack_params(p: ModelParams) -> PackedRNN:
    gi = (p.gru1_input, p.gru2_input, p.gru3_input)
    gr = (p.gru1_recurrent, p.gru2_recurrent, p.gru3_recurrent)
    return PackedRNN(
        conv1_w=p.conv1.weights_f32.contiguous(),
        conv1_b=p.conv1.bias.contiguous(),
        conv2_w=pack_int8(p.conv2.weights_q),
        conv2_scale=p.conv2.scale.contiguous(),
        conv2_b=p.conv2.bias.contiguous(),
        gru_in_w=torch.stack([pack_int8(x.weights_q) for x in gi]),
        gru_in_scale=torch.stack([x.scale for x in gi]),
        gru_in_b=torch.stack([x.bias for x in gi]),
        gru_rec_w=torch.stack([pack_int8(x.weights_q) for x in gr]),
        gru_rec_scale=torch.stack([x.scale for x in gr]),
        gru_rec_b=torch.stack([x.bias for x in gr]),
        gru_diag=torch.stack([x.diag for x in gr]),
        heads_w=torch.cat([p.dense_out.weights_f32,
                           p.vad_dense.weights_f32], dim=1).t().contiguous(),
        heads_b=torch.cat([p.dense_out.bias, p.vad_dense.bias]),
    )


# pack_params memoised by identity; holds the params so ids stay valid
# (models are few and long-lived).
_PACKED: dict = {}


def packed_params(params: ModelParams) -> PackedRNN:
    hit = _PACKED.get(id(params))
    if hit is None or hit[0] is not params:
        hit = _PACKED[id(params)] = (params, pack_params(params))
    return hit[1]


def compute_rnn_plain(params: ModelParams, state: RNNState,
                      feats: torch.Tensor,
                      silence: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel: (new_state, gains, vad)."""
    return compute_rnn_layers(params, state, feats, True, True, silence)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kernels.library("rnn_step")
        lib.rnnt_rnn_step.restype = ctypes.c_int
        lib.rnnt_rnn_step.argtypes = ([ctypes.c_void_p] * 28
                                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        _LIB = lib
    return _LIB


def compute_rnn_step(params: ModelParams, state: RNNState,
                     feats: torch.Tensor,
                     silence: Optional[torch.Tensor] = None):
    """One RNN step: feats [S, 65] -> (new_state, gains [S, 32], vad [S]).
    ``silence`` [S] bool rows keep their state and get VAD 0.  CUDA tensors
    launch the kernel; CPU tensors take :func:`compute_rnn_plain`."""
    if not feats.is_cuda:
        return compute_rnn_plain(params, state, feats, silence)
    pk = packed_params(params)
    dev = feats.device
    S, F = feats.shape
    C, N = pk.conv1_b.shape[0], pk.conv2_b.shape[0]
    NB = pk.heads_b.shape[0] - 1
    if (3 * C) % 4 or N % 4:
        raise ValueError(f"kernel needs 3*cond ({3 * C}) and gru ({N}) "
                         "to be multiples of 4")
    if silence is None:
        silence = torch.zeros(S, dtype=torch.bool, device=dev)
    feats, silence = feats.contiguous(), silence.contiguous()
    st = RNNState(*(t.contiguous() for t in state))
    f32 = torch.float32
    for name, t, shape, dt in (
            ("feats", feats, (S, F), f32), ("silence", silence, (S,), torch.bool),
            ("conv1_mem", st.conv1_mem, (S, 2 * F), f32),
            ("conv2_mem", st.conv2_mem, (S, 2 * C), f32),
            ("gru1", st.gru1, (S, N), f32), ("gru2", st.gru2, (S, N), f32),
            ("gru3", st.gru3, (S, N), f32),
            ("conv1_w", pk.conv1_w, (3 * F, C), f32),
            ("gru_in_w", pk.gru_in_w, (3, N // 4, 3 * N), torch.int32),
            ("heads_w", pk.heads_w, (NB + 1, 4 * N), f32)):
        kernels.require(t, name, shape, dt, dev)
    out = RNNState(*(torch.empty_like(t) for t in st))
    gains = torch.empty((S, NB), dtype=f32, device=dev)
    vad = torch.empty((S,), dtype=f32, device=dev)
    p = kernels.ptr
    kernels.launch(
        _lib().rnnt_rnn_step, "rnn_step", dev,
        p(feats), p(silence), *(p(t) for t in st), *(p(t) for t in pk),
        *(p(t) for t in out), p(gains), p(vad), S, F, C, N, NB)
    compute_rnn_step.launches += 1
    return out, gains, vad


compute_rnn_step.launches = 0

"""Batched NN layers with the reference's exact numerics (gate order, dual
bias, diagonal term, int8 activation quantisation) — the PyTorch counterpart
of ``rnnoise_tpu/nn/layers.py``: the layers the RNNoise graph runs, and the
NN runtime's others (``lpcnet_exp2``, ``relu``, ``swish``, ``softmax``,
``glu``, ``conv2d_step``), which it does not.

Every product is computed so that its f32 result is the correctly rounded
exact value: int8 x int8 dots are exact integers (accumulated in f64, which
holds them exactly), and f32 dots accumulate in f64 before one rounding to
f32.  So the plain path and the CUDA kernel (``csrc/rnn_step.cu``), which
does the same, agree bit for bit whatever order either sums in, and neither
meets TF32.

Two numerics modes mirror the reference:
  * quantized=False — float weights (nnet_arch.h:138-140)
  * quantized=True  — s8 weights with activations quantised as
    ``floor(.5 + 127 x)`` and per-output-column scales (vec.h:248-312).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LinearParams(NamedTuple):
    """One affine layer (reference LinearLayer, src/nnet.h:65-75).

    weights_f32: [in, out] float32 (always present; densified if sparse)
    bias:        [out] float32 or None
    weights_q:   [in, out] int8 or None (quantised layers)
    scale:       [out] float32 (= per-column scale / 127) or None
    diag:        [3N] float32 or None — GRU-recurrent extracted diagonal
    """

    weights_f32: torch.Tensor
    bias: Optional[torch.Tensor]
    weights_q: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None
    diag: Optional[torch.Tensor] = None


# rational approximations that define the reference's numerics (vec.h:337-356)

def tanh_approx(x: torch.Tensor) -> torch.Tensor:
    N0, N1, N2 = 952.52801514, 96.39235687, 0.60863042
    D0, D1, D2 = 952.72399902, 413.36801147, 11.88600922
    x2 = x * x
    num = (N2 * x2 + N1) * x2 + N0
    den = (D2 * x2 + D1) * x2 + D0
    return torch.clamp(num * x / den, -1.0, 1.0)


def sigmoid_approx(x: torch.Tensor) -> torch.Tensor:
    return 0.5 + 0.5 * tanh_approx(0.5 * x)


def _tanh(x, approx):
    return tanh_approx(x) if approx else torch.tanh(x)


def _sigmoid(x, approx):
    return sigmoid_approx(x) if approx else torch.sigmoid(x)


def lpcnet_exp2(x: torch.Tensor) -> torch.Tensor:
    """Bit-trick 2**x (reference lpcnet_exp2, src/vec.h:316-332): a cubic
    polynomial on the fraction, the integer part added into the float's
    exponent field with integer arithmetic; 0 below -50."""
    integer = torch.floor(x)
    frac = x - integer
    poly = 0.99992522 + frac * (0.69583354
                                + frac * (0.22606716 + 0.078024523 * frac))
    bits = poly.float().view(torch.int32)
    bits = (bits + (integer.to(torch.int32) << 23)) & 0x7FFFFFFF
    return torch.where(integer < -50, torch.zeros_like(x),
                       bits.view(torch.float32))


def lpcnet_exp(x: torch.Tensor) -> torch.Tensor:
    """e**x via lpcnet_exp2 (src/vec.h:333)."""
    return lpcnet_exp2(x * 1.44269504)


def relu(x: torch.Tensor) -> torch.Tensor:
    """src/nnet_arch.h:72-75."""
    return torch.clamp(x, min=0.0)


def swish(x: torch.Tensor) -> torch.Tensor:
    """vec_swish (src/nnet_arch.h:62-69): x * sigmoid_approx(x), the
    approximate sigmoid even under HIGH_ACCURACY."""
    return x * sigmoid_approx(x)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The exp-only softmax of compute_activation_c (src/nnet_arch.h:105-119
    without SOFTMAX_HACK, which only nnet.c defines): lpcnet_exp, then the
    reciprocal of the sum plus 1e-30."""
    y = lpcnet_exp(x)
    return y * (1.0 / (torch.sum(y, dim=dim, keepdim=True) + 1e-30))


def quantize_activations(x: torch.Tensor) -> torch.Tensor:
    """s8 activation quantisation: (int)floor(.5 + 127 x)  (vec.h:253, 287)."""
    return torch.clamp(torch.floor(0.5 + 127.0 * x), -127.0, 127.0).to(torch.int8)


def exact_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[S, in] @ [in, out] -> f32, accumulated in f64 (exact for int8
    operands, correctly rounded in practice for f32 ones)."""
    return (x.double() @ w.double()).float()


def linear(p: LinearParams, x: torch.Tensor, quantized: bool) -> torch.Tensor:
    """out = W @ x (+ bias) (+ diag path) — compute_linear_
    (src/nnet_arch.h:130-162), batched: x [S, in] -> [S, out]."""
    if quantized and p.weights_q is not None:
        out = exact_dot(quantize_activations(x), p.weights_q) * p.scale
    else:
        out = exact_dot(x, p.weights_f32)
    if p.bias is not None:
        out = out + p.bias
    if p.diag is not None:
        # GRU-recurrent diagonal, applied to the *unquantised* input
        # (nnet_arch.h:153-161): out[:, g*N + i] += diag[g*N + i] * x[:, i]
        N = x.shape[-1]
        out = out + (x[:, None, :] * p.diag.reshape(3, N)).reshape(-1, 3 * N)
    return out


def dense(p: LinearParams, x: torch.Tensor, activation: str, quantized: bool,
          approx: bool) -> torch.Tensor:
    out = linear(p, x, quantized)
    if activation == "tanh":
        return _tanh(out, approx)
    if activation == "sigmoid":
        return _sigmoid(out, approx)
    raise ValueError(activation)


def conv1d_step(p: LinearParams, mem: torch.Tensor, x: torch.Tensor,
                activation: str, quantized: bool, approx: bool):
    """mem: [S, (k-1)*in] past frames (oldest first); x: [S, in].

    Returns (new_mem, out[S, out]) — compute_generic_conv1d (nnet.c:113-123)
    as a GEMM over the shift register; weight rows are time-major
    oldest-first (wexchange/c_export/common.py:289-294)."""
    tmp = torch.cat([mem, x], dim=-1)
    out = dense(p, tmp, activation, quantized, approx)
    return tmp[:, x.shape[-1]:], out


def glu(p: LinearParams, x: torch.Tensor, quantized: bool) -> torch.Tensor:
    """Gated linear unit (compute_glu, nnet.c:96-109): x * sigmoid(W x).
    Unused by the RNNoise graph."""
    return x * sigmoid_approx(linear(p, x, quantized))


def conv2d_step(weights: torch.Tensor, bias: Optional[torch.Tensor],
                mem: torch.Tensor, x: torch.Tensor, activation: str,
                approx: bool = True):
    """Streaming Conv2d over (time, height) with a carried (ktime-1)-frame
    input memory (compute_conv2d, nnet_arch.h:225-251).  Unused by the
    RNNoise graph.

    weights: [out_ch, in_ch, ktime, kheight]; x: [S, in_ch, H + kheight - 1];
    mem: [S, ktime-1, in_ch, H + kheight - 1].  Returns (new_mem,
    out [S, out_ch, H]).  The products accumulate in f64 and round once, as
    ``exact_dot``'s do: true f32, never TF32."""
    out_ch, in_ch, ktime, kheight = weights.shape
    buf = torch.cat([mem, x[:, None]], dim=1)          # [S, ktime, C, Hin]
    lhs = buf.reshape(buf.shape[0], ktime * in_ch, -1)
    w = weights.permute(0, 2, 1, 3).reshape(out_ch, ktime * in_ch, kheight)
    out = torch.nn.functional.conv1d(lhs.double(), w.double()).float()
    if bias is not None:
        out = out + bias[None, :, None]
    if activation == "tanh":
        out = _tanh(out, approx)
    elif activation == "sigmoid":
        out = _sigmoid(out, approx)
    return buf[:, 1:], out


def gru_step(p_in: LinearParams, p_rec: LinearParams, state: torch.Tensor,
             x: torch.Tensor, quantized: bool, approx: bool) -> torch.Tensor:
    """One GRU step (compute_generic_gru, nnet.c:65-94), gate order z, r, n.
    state: [S, N], x: [S, in] -> new state [S, N]."""
    N = state.shape[-1]
    zrh = linear(p_in, x, quantized)
    recur = linear(p_rec, state, quantized)
    zr = _sigmoid(zrh[:, :2 * N] + recur[:, :2 * N], approx)
    z, r = zr[:, :N], zr[:, N:]
    h = _tanh(zrh[:, 2 * N:] + recur[:, 2 * N:] * r, approx)
    return z * state + (1.0 - z) * h

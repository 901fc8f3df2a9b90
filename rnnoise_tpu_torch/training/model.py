"""Trainable sequence-mode RNNoise model — the PyTorch counterpart of
``rnnoise_tpu/training/model.py`` (reference torch/rnnoise/rnnoise.py:58-109).

Parameters are a plain nested dict of f32 tensors in the same layouts the
inference runtime uses ([in, out] matrices, GRU gate order z, r, n — the
exporter's "C order", wexchange/c_export/common.py:342-353), so exporting
and loading need no transposition games, and the JAX package's param tree
carries across unchanged (:func:`params_from_numpy`, :func:`params_to_numpy`).

Forward semantics match the reference model: two 'valid' Conv1d(k=3) with
tanh (output length T-4), three stacked GRUs as a loop over time, sigmoid
gain and VAD heads on the concat [conv2, gru1, gru2, gru3].  It is plain
PyTorch with autograd (the JAX package's is ``lax.scan`` and ``jnp.dot``,
no Pallas); its matrix products run in f32 (``config.resolve_device``
turns TF32 off on CUDA).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import DEFAULT_MODEL, ModelConfig, resolve_device

# Time steps a GRU's backward pass recomputes together under ``remat``: only
# the hidden state at each segment's start is kept through the forward pass.
# A checkpoint per step would add a launch-bound call per frame.
REMAT_SEGMENT = 100


def init_params(generator: torch.Generator,
                config: ModelConfig = DEFAULT_MODEL, device="cuda") -> Dict:
    """The reference's initialisation (rnnoise.py:52-56 init_weights):
    U(±1/sqrt(fan_in)) for conv/dense, U(±1/sqrt(N)) for GRU weights and
    biases with an orthogonal [3N, N] recurrent matrix, stored transposed.
    Drawn on the CPU from ``generator`` (a CPU generator), so a seed gives
    the same params on every device, then moved to ``device``."""
    c, g, f, nb = (config.cond_size, config.gru_size, config.input_dim,
                   config.output_dim)
    k = config.conv_kernel

    def unif(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return (torch.rand(shape, generator=generator) * (2 * bound)
                - bound)

    def orthogonal(rows, cols):
        """[rows, cols] with orthonormal columns (rows >= cols): the Q of a
        Gaussian matrix's QR with R's diagonal made positive."""
        q, r = torch.linalg.qr(torch.randn((rows, cols), generator=generator))
        return q * torch.sign(torch.diagonal(r))[None, :]

    def gru(in_dim, n):
        return dict(w_in=unif((in_dim, 3 * n), n), b_in=unif((3 * n,), n),
                    w_rec=orthogonal(3 * n, n).T.contiguous(),
                    b_rec=unif((3 * n,), n))

    params = dict(
        conv1=dict(w=unif((k * f, c), k * f), b=unif((c,), k * f)),
        conv2=dict(w=unif((k * c, g), k * c), b=unif((g,), k * c)),
        gru1=gru(g, g), gru2=gru(g, g), gru3=gru(g, g),
        dense_out=dict(w=unif((4 * g, nb), 4 * g), b=unif((nb,), 4 * g)),
        vad_dense=dict(w=unif((4 * g, 1), 4 * g), b=unif((1,), 4 * g)),
    )
    device = resolve_device(device)
    return map_params(lambda t: t.to(device).requires_grad_(), params)


def map_params(fn, params: Dict) -> Dict:
    """``fn`` applied to every leaf of the two-level param dict."""
    return {layer: {name: fn(t) for name, t in leaves.items()}
            for layer, leaves in params.items()}


def param_leaves(params: Dict) -> list:
    """The leaves in a fixed order (layer, then name)."""
    return [params[layer][name] for layer in params for name in params[layer]]


def params_from_numpy(tree: Dict, device="cuda") -> Dict:
    """The JAX package's param tree as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) as this package's, on ``device``,
    leaves that take gradients."""
    device = resolve_device(device)
    return map_params(lambda a: torch.from_numpy(np.array(a, np.float32))
                      .to(device).requires_grad_(), tree)


def params_to_numpy(params: Dict) -> Dict:
    """The params as the JAX package's tree of f32 numpy arrays."""
    return map_params(lambda t: t.detach().cpu().numpy(), params)


def _conv_valid(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] -> tanh(conv1d_valid(x)) [B, T-2, O]; weight rows are
    time-major oldest-first ([x_{t-2}, x_{t-1}, x_t] per output frame)."""
    T = x.shape[1]
    xw = torch.cat([x[:, 0:T - 2], x[:, 1:T - 1], x[:, 2:T]], dim=-1)
    return torch.tanh(xw @ w + b)


def _gru_steps(h: torch.Tensor, xz: torch.Tensor, w_rec: torch.Tensor,
               b_rec: torch.Tensor):
    """h: [B, N], xz: [B, t, 3N] (the input projections) -> (outputs
    [B, t, N], h after the last step).  Gate order z, r, n:
    h' = z*h + (1-z)*tanh(xn + r*hn).

    The sequence is split into its steps, and each step's projections into
    their gates, by one unbind and one split each: indexing a step or a gate
    instead would give each its own backward node, which writes its
    gradient into zeros the size of the whole operand."""
    N = h.shape[-1]
    x_zr, x_n = xz.split([2 * N, N], dim=-1)
    ys = []
    for xt_zr, xt_n in zip(x_zr.unbind(1), x_n.unbind(1)):
        rec_zr, rec_n = torch.addmm(b_rec, h, w_rec).split([2 * N, N], dim=-1)
        z, r = torch.sigmoid(xt_zr + rec_zr).chunk(2, dim=-1)
        n = torch.tanh(xt_n + r * rec_n)
        h = z * h + (1.0 - z) * n
        ys.append(h)
    return torch.stack(ys, dim=1), h


def _gru_seq(p: Dict, x: torch.Tensor, h0: torch.Tensor,
             remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, in], h0: [B, N] -> (outputs [B, T, N], h_T [B, N]).

    ``x @ w_in`` runs once for the sequence.  ``remat`` recomputes the gate
    activations in the backward pass, REMAT_SEGMENT steps at a time, so that
    only the segments' first hidden states and the outputs stay stored —
    the default 128 x 2000-frame BPTT would otherwise hold ~10 GB of gate
    activations."""
    xz = x @ p["w_in"] + p["b_in"]                       # [B, T, 3N]
    if not remat:
        return _gru_steps(h0, xz, p["w_rec"], p["b_rec"])
    ys, h = [], h0
    for seg in xz.split(REMAT_SEGMENT, dim=1):
        y, h = checkpoint(_gru_steps, h, seg, p["w_rec"], p["b_rec"],
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def forward(params: Dict, features: torch.Tensor,
            states: Optional[Tuple] = None, remat: bool = False):
    """features: [B, T, 65] -> (gain [B, T-4, 32], vad [B, T-4, 1],
    states (h1, h2, h3), each [B, N]).

    Mirrors RNNoise.forward (torch/rnnoise/rnnoise.py:86-109)."""
    B = features.shape[0]
    N = params["gru1"]["w_rec"].shape[0]
    if states is None:
        states = tuple(torch.zeros((B, N), dtype=torch.float32,
                                   device=features.device) for _ in range(3))
    c1 = _conv_valid(features, params["conv1"]["w"], params["conv1"]["b"])
    c2 = _conv_valid(c1, params["conv2"]["w"], params["conv2"]["b"])
    g1, h1 = _gru_seq(params["gru1"], c2, states[0], remat)
    g2, h2 = _gru_seq(params["gru2"], g1, states[1], remat)
    g3, h3 = _gru_seq(params["gru3"], g2, states[2], remat)
    cat = torch.cat([c2, g1, g2, g3], dim=-1)
    gain = torch.sigmoid(cat @ params["dense_out"]["w"]
                         + params["dense_out"]["b"])
    vad = torch.sigmoid(cat @ params["vad_dense"]["w"]
                        + params["vad_dense"]["b"])
    return gain, vad, (h1, h2, h3)

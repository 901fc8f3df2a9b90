"""Direct-form-II-transposed biquad, batched over streams — the counterpart
of ``rnnoise_tpu/dsp/biquad.py``.

The reference runs a per-sample loop with double accumulators
(src/denoise.c:409-419).  The filter is LTI and a frame has a static length,
so it unrolls in closed form:

    y_i     = x_i + (A^i)[0,:] @ s_{-1}  +  sum_{j<i} k_{i-1-j} x_j
    s_{N-1} = A^N @ s_{-1}  +  sum_j (A^{N-1-j} B) x_j

with every A-power precomputed in float64, so a frame is one
lower-triangular [N, N] f32 matmul plus two tiny state terms.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _biquad_kernels(b: tuple, a: tuple, N: int):
    A = np.array([[-a[0], 1.0], [-a[1], 0.0]], dtype=np.float64)
    B = np.array([b[0] - a[0], b[1] - a[1]], dtype=np.float64)
    powers = np.empty((N + 1, 2, 2), dtype=np.float64)       # A^i, i = 0..N
    powers[0] = np.eye(2)
    for i in range(1, N + 1):
        powers[i] = A @ powers[i - 1]
    k = (powers[:N - 1] @ B)[:, 0]                    # k_d, d = 0..N-2
    K = np.zeros((N, N), dtype=np.float64)            # K[i, j] = k_{i-1-j}
    i, j = np.tril_indices(N, k=-1)
    K[i, j] = k[i - 1 - j]
    rowA = powers[:N, 0, :]                           # (A^i)[0, :]  [N, 2]
    SA = powers[N]                                    # A^N          [2, 2]
    SB = powers[N - 1::-1] @ B                        # A^{N-1-j} B  [N, 2]
    return K, rowA, SA, SB


@functools.lru_cache(maxsize=None)
def _device_kernels(b: tuple, a: tuple, N: int, device: str):
    """(K^T, rowA^T, SA^T, SB) on ``device``: K^T in f32, the state terms
    in f64 (as exact f64 powers) or f32, after the state rounding mode."""
    K, rowA, SA, SB = _biquad_kernels(b, a, N)
    dt = np.float64 if _STATE_ROUNDING == "f64" else np.float32
    return tuple(torch.from_numpy(np.ascontiguousarray(m, dtype=t)).to(device)
                 for m, t in ((K.T, np.float32), (rowA.T, dt), (SA.T, dt),
                              (SB, dt)))


# How the [S, 2] filter state is updated at each frame's end.  "f64": the
# state terms in float64 from the exact f64 A-powers, rounded once to the f32
# state (the reference keeps double product accumulators,
# src/denoise.c:409-419).  "xla_cpu": rounded as the JAX package's compiled
# CPU graph rounds its f32 dots (the 2-term products as one FMA, the frame's
# input products as four FMA chains), which makes the two packages' states
# bit-identical.  The state map A^N of this near-unstable DC blocker has
# norm ~290, so a 1-ulp difference in the state reaches output LSBs within
# frames: comparing the rest of the pipeline with the JAX package to its
# budget needs "xla_cpu"; serving uses "f64".
_STATE_ROUNDING = "f64"          # "f64" | "xla_cpu"


def set_state_rounding(mode: str) -> str:
    """Select the state update; returns the mode it replaces."""
    global _STATE_ROUNDING
    assert mode in ("f64", "xla_cpu")
    old, _STATE_ROUNDING = _STATE_ROUNDING, mode
    _device_kernels.cache_clear()
    return old


def _dot2(mem: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """mem [R, 2] @ m [2, W] rounded as fma(mem1, m1, mem0 * m0)."""
    p0 = mem[:, :1] * m[0]
    return (mem[:, 1:].double() * m[1].double() + p0.double()).float()


def _dot_lanes4(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x [R, N] @ m [N, W] summed in f32 as four FMA chains (term j goes to
    chain j % 4), combined as (c0 + c1) + (c2 + c3)."""
    R, N = x.shape
    xd = x.double().reshape(R, N // 4, 4, 1)
    md = m.double().reshape(N // 4, 4, -1)
    acc = torch.zeros((R, 4, m.shape[1]), dtype=torch.float32,
                      device=x.device)
    for j in range(N // 4):
        acc = torch.addcmul(acc.double(), xd[:, j], md[j]).float()
    return (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])


def biquad_frames(x: torch.Tensor, mem: torch.Tensor, b, a):
    """x: [T, S, N] consecutive frames, mem: [S, 2] -> (y [T, S, N],
    new_mem [S, 2]).

    The input products of all T frames are summed together; only the 2-dim
    state chains frame to frame, updated as ``_STATE_ROUNDING`` says."""
    b = tuple(float(v) for v in np.asarray(b, dtype=np.float64))
    a = tuple(float(v) for v in np.asarray(a, dtype=np.float64))
    T, S, N = x.shape
    KT, rowAT, SAT, SB = _device_kernels(b, a, N, str(x.device))
    x = x.float()
    flat = x.reshape(T * S, N)
    xk = (flat @ KT).reshape(T, S, N)
    ys = []
    if _STATE_ROUNDING == "f64":
        v = (flat.double() @ SB).reshape(T, S, 2)
        for t in range(T):
            m = mem.double()
            ys.append(x[t] + xk[t] + (m @ rowAT).float())
            mem = (m @ SAT + v[t]).float()
    else:
        v = _dot_lanes4(flat, SB).reshape(T, S, 2)
        for t in range(T):
            ys.append(x[t] + xk[t] + _dot2(mem, rowAT))
            mem = _dot2(mem, SAT) + v[t]
    return torch.stack(ys), mem


def biquad(x: torch.Tensor, mem: torch.Tensor, b, a):
    """x: [S, N], mem: [S, 2]  ->  (y[S, N], new_mem[S, 2])."""
    y, mem = biquad_frames(x[None], mem, b, a)
    return y[0], mem

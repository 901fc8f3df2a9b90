"""The forward and inverse spectra as CUDA kernels (``csrc/spectral.cu``) —
the port of ``rnnoise_tpu/dsp/pallas_spectral.py:forward_spectral`` and
``inverse_spectral``.

Unlike the TPU kernels, which keep a permuted 488-wide bin order, these
work in natural order: spectra are ``[S, 962]`` re|im.  Each wrapper
launches its kernel for CUDA tensors and uses its plain version (a dense
DFT matmul from ``transform.py``, in f64 for the forward spectra) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels, tables
from ..config import FRAME_SIZE, FREQ_SIZE, PITCH_BUF_SIZE, WINDOW_SIZE
from .transform import windowed_forward_transform, windowed_inverse_transform

# Largest window start that stays inside the pitch buffer; both versions
# clamp ``start`` to [0, MAX_START] (the main path gives [1, 708]).
MAX_START = PITCH_BUF_SIZE - WINDOW_SIZE


def take_window(pitch_buf: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """out[s, i] = pitch_buf[s, start[s] + i] for i < 960."""
    idx = start.long().clamp(0, MAX_START)[:, None] \
        + torch.arange(WINDOW_SIZE, device=pitch_buf.device)
    return torch.gather(pitch_buf, 1, idx)


def forward_spectral_plain(mem, x, pitch_buf, start):
    """Plain version: (X, P), each [S, 962] re|im, of the windowed
    [mem | x] and the windowed pitch_buf[start : start+960]."""
    S = x.shape[0]
    v = torch.cat([mem, x], dim=-1)
    both = windowed_forward_transform(
        torch.cat([v, take_window(pitch_buf, start)], dim=0))
    return both[:S], both[S:]


def inverse_spectral_plain(Y):
    """Plain version: [S, 962] re|im -> [S, 960] synthesis-windowed."""
    return windowed_inverse_transform(Y)


@functools.lru_cache(maxsize=None)
def kernel_tables(device: str):
    """(window [960] f32, twiddles [960, 2] f64 = cos, sin of 2 pi m / 960;
    the inverse kernel rounds them to f32)."""
    m = np.arange(WINDOW_SIZE)
    tw = np.stack([np.cos(2 * np.pi * m / WINDOW_SIZE),
                   np.sin(2 * np.pi * m / WINDOW_SIZE)], axis=1)
    q = WINDOW_SIZE // 4                   # exact values at quarter turns
    tw[0::q] = [[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]
    return (torch.from_numpy(tables.full_window().copy()).to(device),
            torch.from_numpy(tw).to(device))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kernels.library("spectral")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_forward_spectral.restype = i
        lib.rnnt_forward_spectral.argtypes = [p] * 8 + [i, p]
        lib.rnnt_inverse_spectral.restype = i
        lib.rnnt_inverse_spectral.argtypes = [p] * 4 + [i, p]
        _LIB = lib
    return _LIB


def forward_spectral(mem, x, pitch_buf, start):
    """mem, x: [S, 480] f32; pitch_buf: [S, 1728] f32; start: [S] int32.
    Returns (X, P): [S, 962] f32 re|im, scaled 1/960."""
    if not x.is_cuda:
        return forward_spectral_plain(mem, x, pitch_buf, start)
    S, dev = x.shape[0], x.device
    mem, x, pitch_buf = mem.contiguous(), x.contiguous(), pitch_buf.contiguous()
    start = start.to(torch.int32).contiguous()
    f32 = torch.float32
    kernels.require(mem, "mem", (S, FRAME_SIZE), f32, dev)
    kernels.require(x, "x", (S, FRAME_SIZE), f32, dev)
    kernels.require(pitch_buf, "pitch_buf", (S, PITCH_BUF_SIZE), f32, dev)
    kernels.require(start, "start", (S,), torch.int32, dev)
    window, tw = kernel_tables(str(dev))
    X = torch.empty((S, 2 * FREQ_SIZE), dtype=f32, device=dev)
    P = torch.empty_like(X)
    p = kernels.ptr
    rc = _lib().rnnt_forward_spectral(p(mem), p(x), p(pitch_buf), p(start),
                                      p(window), p(tw), p(X), p(P), S,
                                      kernels.stream())
    kernels.check(rc, "forward_spectral")
    forward_spectral.launches += 1
    return X, P


def inverse_spectral(Y):
    """Y: [S, 962] f32 re|im -> [S, 960] f32, inverse DFT (unscaled) times
    the synthesis window."""
    if not Y.is_cuda:
        return inverse_spectral_plain(Y)
    S, dev = Y.shape[0], Y.device
    Y = Y.contiguous()
    kernels.require(Y, "Y", (S, 2 * FREQ_SIZE), torch.float32, dev)
    window, tw = kernel_tables(str(dev))
    out = torch.empty((S, WINDOW_SIZE), dtype=torch.float32, device=dev)
    p = kernels.ptr
    rc = _lib().rnnt_inverse_spectral(p(Y), p(window), p(tw), p(out), S,
                                      kernels.stream())
    kernels.check(rc, "inverse_spectral")
    inverse_spectral.launches += 1
    return out


forward_spectral.launches = 0
inverse_spectral.launches = 0

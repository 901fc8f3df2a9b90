"""The pitch analysis from the coarse candidates to both forward spectra as
one CUDA kernel (``csrc/analysis.cu``) — the port of
``rnnoise_tpu/dsp/pallas_analysis.py:analysis_spectral``.

Per stream: the lag table and the sliding 480-tap energies of the whitened,
decimated pitch buffer ``ds``, the fine search with its pseudo-
interpolation, the remove_doubling ladder, then the pitch window at the
resolved period and the windowed forward spectra X and P, in natural order
``[S, 962]`` re|im (the same values ``cuda_spectral.forward_spectral``
gives for that window).  The coarse search stays outside, in PyTorch.

The plain version is the port's own chain (``pitch.fine_search``,
``pitch.remove_doubling``, ``cuda_spectral.forward_spectral_plain``), with
the lag table and the energies summed in f64 and rounded once, as the
kernel sums them (on the f64 tensor cores, in the plan of
``cuda_xcorr.lag_mma_tiles``).  ``analysis_spectral`` launches the kernel
for CUDA tensors and uses the plain version for CPU tensors.
:func:`lag_energy_table` runs the kernel's lag table and energies alone
(``rnnt_lag_energy_table``), so that they can be held against their plain
versions value by value.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..config import (FRAME_SIZE, FREQ_SIZE, PITCH_BUF_SIZE, PITCH_MAX_PERIOD,
                      WINDOW_SIZE)
from . import cuda_spectral, pitch
from .cuda_xcorr import CORR_LEN, DS_LEN, N_LAGS, lag_corr_table_plain

N_FINE = pitch.FINE_LAGS      # 294


def lag_energy_table_plain(ds):
    """Plain version of :func:`lag_energy_table`: the lag table and the
    energies as f64 convolutions, each rounded once."""
    return lag_corr_table_plain(ds), pitch.window_energy(ds, CORR_LEN, N_LAGS)


def analysis_spectral_plain(mem, x, pitch_buf, ds, bp0, bp1, prev_period,
                            prev_gain):
    """Plain version of :func:`analysis_spectral`."""
    bx, yy = lag_energy_table_plain(ds)
    syy = torch.clamp(1.0 + yy[:, :N_FINE], min=1.0)
    fine = pitch.fine_search(bx, syy, bp0, bp1)
    T0, gain = pitch.remove_doubling(ds, PITCH_MAX_PERIOD - fine, prev_period,
                                     prev_gain, bx, yy)
    X, P = cuda_spectral.forward_spectral_plain(
        mem, x, pitch_buf, PITCH_BUF_SIZE - WINDOW_SIZE - T0)
    return X, P, T0, gain


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kernels.library("analysis")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_analysis_spectral.restype = i
        lib.rnnt_analysis_spectral.argtypes = [p] * 14 + [i, p]
        lib.rnnt_lag_energy_table.restype = i
        lib.rnnt_lag_energy_table.argtypes = [p, p, p, i, p]
        _LIB = lib
    return _LIB


def analysis_spectral(mem, x, pitch_buf, ds, bp0, bp1, prev_period, prev_gain):
    """mem, x: [S, 480] f32; pitch_buf: [S, 1728] f32; ds: [S, 864] f32;
    bp0, bp1: [S] int32 coarse candidates; prev_period: [S] int32 (48 kHz
    units); prev_gain: [S] f32.  Returns (X, P, T0, gain): [S, 962] f32 re|im
    twice, [S] int32 in 48 kHz units, [S] f32."""
    if not x.is_cuda:
        return analysis_spectral_plain(mem, x, pitch_buf, ds, bp0, bp1,
                                       prev_period, prev_gain)
    S, dev, f32, i32 = x.shape[0], x.device, torch.float32, torch.int32
    mem, x, pitch_buf, ds, prev_gain = (
        t.contiguous() for t in (mem, x, pitch_buf, ds, prev_gain))
    bp0, bp1, prev_period = (t.to(i32).contiguous()
                             for t in (bp0, bp1, prev_period))
    kernels.require(mem, "mem", (S, FRAME_SIZE), f32, dev)
    kernels.require(x, "x", (S, FRAME_SIZE), f32, dev)
    kernels.require(pitch_buf, "pitch_buf", (S, PITCH_BUF_SIZE), f32, dev)
    kernels.require(ds, "ds", (S, DS_LEN), f32, dev)
    for name, t in (("bp0", bp0), ("bp1", bp1), ("prev_period", prev_period)):
        kernels.require(t, name, (S,), i32, dev)
    kernels.require(prev_gain, "prev_gain", (S,), f32, dev)
    window = cuda_spectral.kernel_tables(str(dev))[0]
    tw = cuda_spectral.fft_tables(str(dev))
    X = torch.empty((S, 2 * FREQ_SIZE), dtype=f32, device=dev)
    P = torch.empty_like(X)
    T0 = torch.empty((S,), dtype=i32, device=dev)
    gain = torch.empty((S,), dtype=f32, device=dev)
    p = kernels.ptr
    kernels.launch(
        _lib().rnnt_analysis_spectral, "analysis_spectral", dev,
        p(mem), p(x), p(pitch_buf), p(ds), p(bp0), p(bp1), p(prev_period),
        p(prev_gain), p(window), p(tw), p(X), p(P), p(T0), p(gain), S)
    analysis_spectral.launches += 1
    return X, P, T0, gain


analysis_spectral.launches = 0


def lag_energy_table(ds):
    """ds: [S, 864] f32 -> (bx, yy): [S, 385] f32 each, the lag table and the
    sliding 480-tap energies as the analysis kernel computes them."""
    if not ds.is_cuda:
        return lag_energy_table_plain(ds)
    S, dev = ds.shape[0], ds.device
    ds = ds.contiguous()
    kernels.require(ds, "ds", (S, DS_LEN), torch.float32, dev)
    bx = torch.empty((S, N_LAGS), dtype=torch.float32, device=dev)
    yy = torch.empty_like(bx)
    kernels.launch(_lib().rnnt_lag_energy_table, "lag_energy_table", dev,
                   kernels.ptr(ds), kernels.ptr(bx), kernels.ptr(yy), S)
    lag_energy_table.launches += 1
    return bx, yy


lag_energy_table.launches = 0

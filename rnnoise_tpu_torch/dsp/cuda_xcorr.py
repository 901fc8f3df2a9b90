"""The lag-correlation table as a CUDA kernel (``csrc/analysis.cu``) — the
port of ``rnnoise_tpu/dsp/pallas_xcorr.py:lag_corr_table_pallas``.

    bx[s, i] = sum_{j<480} ds[s, 384 + j] * ds[s, i + j],   i = 0..384

Both versions sum in f64 and round once to f32: a product of two floats is
exact in f64, so the result hardly depends on the order of the sum, and the
pitch ranking that reads the table (on ~1e-4 knife edges) sees the same
values from either.  ``lag_corr_table_kernel`` launches the kernel for CUDA
tensors and uses :func:`lag_corr_table_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as Fn

from .. import kernels
from ..config import PITCH_BUF_SIZE, PITCH_FRAME_SIZE, PITCH_MAX_PERIOD

DS_LEN = PITCH_BUF_SIZE // 2             # 864, the decimated pitch buffer
X_OFF = PITCH_MAX_PERIOD // 2            # 384: x = ds[384 : 864]
CORR_LEN = PITCH_FRAME_SIZE // 2         # 480
N_LAGS = PITCH_MAX_PERIOD // 2 + 1       # 385


def lag_corr_table_plain(ds: torch.Tensor) -> torch.Tensor:
    """Plain version: one grouped f64 convolution (a filter per stream),
    rounded to f32."""
    d = ds.double()
    w = d[:, None, X_OFF:X_OFF + CORR_LEN]
    return Fn.conv1d(d[None], w, groups=ds.shape[0])[0].float()


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kernels.library("analysis")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_lag_corr_table.restype = i
        lib.rnnt_lag_corr_table.argtypes = [p, p, i, p]
        _LIB = lib
    return _LIB


def lag_corr_table_kernel(ds: torch.Tensor) -> torch.Tensor:
    """ds: [S, 864] f32 whitened, decimated pitch buffer -> bx [S, 385] f32."""
    if not ds.is_cuda:
        return lag_corr_table_plain(ds)
    S, dev = ds.shape[0], ds.device
    ds = ds.contiguous()
    kernels.require(ds, "ds", (S, DS_LEN), torch.float32, dev)
    bx = torch.empty((S, N_LAGS), dtype=torch.float32, device=dev)
    kernels.launch(_lib().rnnt_lag_corr_table, "lag_corr_table", dev,
                   kernels.ptr(ds), kernels.ptr(bx), S)
    lag_corr_table_kernel.launches += 1
    return bx


lag_corr_table_kernel.launches = 0

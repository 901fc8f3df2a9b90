"""The lag-correlation table as a CUDA kernel (``csrc/analysis.cu``) — the
port of ``rnnoise_tpu/dsp/pallas_xcorr.py:lag_corr_table_pallas``.

    bx[s, i] = sum_{j<480} ds[s, 384 + j] * ds[s, i + j],   i = 0..384

Both versions sum in f64 and round once to f32: a product of two floats is
exact in f64, so the result hardly depends on the order of the sum, and the
pitch ranking that reads the table (on ~1e-4 knife edges) sees the same
values from either.  ``lag_corr_table_kernel`` launches the kernel for CUDA
tensors and uses :func:`lag_corr_table_plain` for CPU tensors.

The kernel's tile shape (``analysis_body.cuh``: ``LAG_TILE``,
``TAP_SLICE``), which this module holds too: a thread sums LAGS_PER_THREAD
consecutive lags over one slice of TAPS_PER_SLICE consecutive taps, in
ascending tap order; the slices of a lag are then added as
``((s0 + s1) + (s2 + s3))`` (:func:`lag_tile_partition`).
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
LAGS_PER_THREAD = 7
TAPS_PER_SLICE = 120
TAP_SLICES = CORR_LEN // TAPS_PER_SLICE  # 4
SLICE_LANES = 64                         # threads of a slice: two warps


def lag_tile_partition():
    """The kernel's busy threads as (thread, lags, taps): of the
    TAP_SLICES x SLICE_LANES threads of a stream, thread t owns slice
    t // SLICE_LANES (TAPS_PER_SLICE consecutive taps, summed in ascending
    order) and, while t % SLICE_LANES < 55, tile t % SLICE_LANES
    (LAGS_PER_THREAD consecutive lags)."""
    out = []
    for t in range(TAP_SLICES * SLICE_LANES):
        sl, tile = divmod(t, SLICE_LANES)
        if tile < N_LAGS // LAGS_PER_THREAD:
            out.append((t, range(tile * LAGS_PER_THREAD, (tile + 1) * LAGS_PER_THREAD),
                        range(sl * TAPS_PER_SLICE, (sl + 1) * TAPS_PER_SLICE)))
    return out


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

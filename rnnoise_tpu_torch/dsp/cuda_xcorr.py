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

The analysis kernel's lag table and energies (``analysis_body.cuh``:
``lag_energy_mma``, shared with the whole-chunk kernel) run as f64
tensor-core products, whose plan this module holds too: a tile is the
MMA_M x MMA_N output of one chain of ``mma.sync`` m16n8k8 f64 products,
lags ``L0 + row + MMA_M n``, over MMA_KSTEPS steps of MMA_K taps; MMA_TILES
tiles hold lags 0..383 and one warp sums lag 384 (:func:`lag_mma_tiles`,
the lanes' fragments :func:`lag_mma_lanes`).
"""

from __future__ import annotations

import ctypes

import numpy as np
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


MMA_M, MMA_N, MMA_K = 16, 8, 8            # the mma's rows, columns and depth
MMA_TILE_LAGS = MMA_M * MMA_N            # 128 lags a tile
MMA_TILES = (N_LAGS - 1) // MMA_TILE_LAGS               # 3: lags 0..383
MMA_K_LEN = CORR_LEN + (MMA_N - 1) * MMA_M               # 592 taps of B's band
MMA_KSTEPS = MMA_K_LEN // MMA_K                          # 74
# ds values a stream's tiles read, ds[0 : MMA_DS_EXTENT]: inside its 864, so
# no zero tail is needed
MMA_DS_EXTENT = (MMA_TILES - 1) * MMA_TILE_LAGS + MMA_M - 1 + MMA_K_LEN
LAG_WARPS = 2                            # warps a stream: the table, the energies


def lag_mma_tiles():
    """One stream's tensor-core products as index arrays of shape
    [MMA_TILES, MMA_KSTEPS, MMA_M, MMA_K, MMA_N] (tile q, step m, A's row,
    A's column k in the step, the output column n): the product
    A[row][k] B[k][n] adds ds[a_idx] x[tap] to lag ``lag`` where
    ``in_band``, and B[k][n] = 0 elsewhere.  Returns (a_idx, lag, tap,
    in_band)."""
    q, m, row, kk, n = np.ix_(np.arange(MMA_TILES), np.arange(MMA_KSTEPS), np.arange(MMA_M),
                              np.arange(MMA_K), np.arange(MMA_N))
    shape = (MMA_TILES, MMA_KSTEPS, MMA_M, MMA_K, MMA_N)
    k = MMA_K * m + kk
    l0 = q * MMA_TILE_LAGS
    tap = np.broadcast_to(k - MMA_M * n, shape)
    return (np.broadcast_to(l0 + row + k, shape), np.broadcast_to(l0 + row + MMA_M * n, shape),
            tap, (tap >= 0) & (tap < CORR_LEN))


def lag_mma_lanes():
    """The fragments of lane 4g + t of a warp at step m of a tile at lag L0,
    as the kernel forms them, beside the places the m16n8k8 f64 product
    takes them from: (a_off, a_rc, b_off, b_rc, c_lag, c_rc), each [32, i]:
    A fragment i is read at ds[L0 + 8m + a_off] (the window u(m), u(m + 1),
    v(m), v(m + 1): g + t + (0, 8, 4, 12)) and stands for A[row][k] at a_rc
    (g + 8 (i % 2), t + 4 (i // 2)); B fragment i is read at
    x[8m + b_off] (t + 4i - 16g) for B[k][n] at b_rc (t + 4i, g); C
    fragment i, C[row][n] at c_rc (g + 8 (i // 2), 2t + i % 2), is stored at
    lag L0 + c_lag (g + 32t + 16 (i % 2) + 8 (i // 2))."""
    lane = np.arange(32)[:, None]
    g, t = lane // 4, lane % 4
    i4, i2 = np.arange(4)[None, :], np.arange(2)[None, :]
    a_off = g + t + np.array([0, 8, 4, 12])[None, :]
    a_rc = np.stack(np.broadcast_arrays(g + 8 * (i4 % 2), t + 4 * (i4 // 2)), -1)
    b_off = np.broadcast_to(t + 4 * i2 - MMA_M * g, (32, 2))
    b_rc = np.stack(np.broadcast_arrays(t + 4 * i2, g + 0 * i2), -1)
    c_lag = g + 2 * MMA_M * t + MMA_M * (i4 % 2) + 8 * (i4 // 2)
    c_rc = np.stack(np.broadcast_arrays(g + 8 * (i4 // 2), 2 * t + i4 % 2), -1)
    return a_off, a_rc, b_off, b_rc, c_lag, c_rc


def lag_mma_ops():
    """(f64 tensor-core multiply-adds, f64 pipe operations) of one stream's
    lag table and energies as lag_energy_mma runs them: a chain of m16n8k8
    products a tile and table (the band's zeros included), and on the f64
    pipe the energy warp's squares (one for each value its window loads) and
    lag 384's 480 multiply-adds and 5 shuffle-adds."""
    mma = 2 * MMA_TILES * MMA_KSTEPS * MMA_M * MMA_N * MMA_K
    loads = MMA_TILES * 2 * (MMA_KSTEPS + 1) * 32
    return mma, loads + CORR_LEN + 5 * 32


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

"""The forward and inverse spectra, and the post-filter with synthesis, as
CUDA kernels (``csrc/spectral.cu``) — the port of
``rnnoise_tpu/dsp/pallas_spectral.py:forward_spectral``,
``inverse_spectral`` and ``postfilter_synthesis``.

Unlike the TPU kernels, which keep a permuted 488-wide bin order, these
work in natural order: spectra are ``[S, 962]`` re|im.  The forward
spectra are two 480-point f64 FFTs per stream, one per input, and the
inverse spectrum (alone and inside the post-filter) one 480-point f64 FFT of
the same stages, all planned in ``fft_plan.py``; the wrappers hand each
kernel their twiddle table.  The post-filter (and the whole-chunk kernel)
read the band tables in a compact form built here from the dense ones
(:func:`band_tables`: each bin touches two neighbouring bands).  Each
wrapper launches its kernel for CUDA
tensors and uses its plain version (dense DFT matmuls from
``transform.py``, in f64 for the forward spectra; the post-filter's band
arithmetic as ``denoise.py`` ran it) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels, tables
from ..config import (FRAME_SIZE, FREQ_SIZE, NB_BANDS, PITCH_BUF_SIZE,
                      WINDOW_SIZE)
from . import fft_plan
from .transform import (frame_synthesis, per_bin, pitch_filter,
                        windowed_forward_transform, windowed_inverse_transform)

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


def postfilter_chain(dX, dP, dEx, dEp, dExp, g, lastg, Ex, silence,
                     synthesis_mem, plain=False):
    """The delayed-frame tail as PyTorch operators around the inverse
    spectrum (its kernel, or its plain version when ``plain``): the comb
    filter and gains applied to the delayed spectrum dX (pitch spectrum dP,
    band energies dEx, dEp, dExp), the silence blend, synthesis and
    overlap-add.  Returns (out [S, 480], synthesis_mem [S, 480],
    lastg [S, 32])."""
    Xd = pitch_filter(dX, dP, dEx, dEp, dExp, g)
    g_capped = torch.maximum(g, 0.6 * lastg)
    lastg_new = torch.clamp(g_capped * (dEx + 1e-3) / (Ex + 1e-3), max=1.0)
    Xd = Xd * per_bin(g_capped)
    sil = silence[:, None]
    X_synth = torch.where(sil, dX, Xd)
    lastg_new = torch.where(sil, lastg, lastg_new)
    synthesis_mem, out = frame_synthesis(synthesis_mem, X_synth, plain)
    return out, synthesis_mem, lastg_new


def postfilter_synthesis_plain(dX, dP, dEx, dEp, dExp, g, lastg, Ex, silence,
                               synthesis_mem):
    """Plain version of :func:`postfilter_synthesis`."""
    return postfilter_chain(dX, dP, dEx, dEp, dExp, g, lastg, Ex, silence,
                            synthesis_mem, plain=True)


@functools.lru_cache(maxsize=None)
def kernel_tables(device: str):
    """(window [960] f32, twiddles [960, 2] f64 = cos, sin of 2 pi m / 960)."""
    m = np.arange(WINDOW_SIZE)
    tw = np.stack([np.cos(2 * np.pi * m / WINDOW_SIZE),
                   np.sin(2 * np.pi * m / WINDOW_SIZE)], axis=1)
    q = WINDOW_SIZE // 4                   # exact values at quarter turns
    tw[0::q] = [[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]
    return (torch.from_numpy(tables.full_window().copy()).to(device),
            torch.from_numpy(tw).to(device))


# The rows of band_tables' pairs, as postfilter_body.cuh names them.
PAIR_INTERP, PAIR_BAND = 0, 1


def band_pairs(m: np.ndarray) -> np.ndarray:
    """The compact form of a bin -> band table m [481, 32] whose rows have
    their nonzeros in two neighbouring bands at most: [481, 4] f32 rows
    (w0, w1, b, 0) with m[k, b] = w0, m[k, b + 1] = w1 and every other entry
    of row k zero; b <= 30 (a row whose only nonzero is band 31 has b = 30,
    w0 = 0), and a row of zeros has b = 0.  Derived from the nonzeros of m
    itself; raises if a row has any other shape."""
    nb = m.shape[1]
    out = np.zeros((m.shape[0], 4), np.float32)
    for k, row in enumerate(m):
        nz = np.flatnonzero(row)
        if not len(nz):
            continue
        b = min(int(nz[0]), nb - 2)
        if nz[-1] > b + 1:
            raise ValueError(f"bin {k} touches bands {list(nz)}")
        out[k] = row[b], row[b + 1], b, 0.0
    return out


def band_ranges(m: np.ndarray) -> np.ndarray:
    """[32, 2] int32 (lo, hi): band b's nonzero bins in m [481, 32] are the
    contiguous range lo <= k < hi; raises if they are not contiguous."""
    out = np.zeros((m.shape[1], 2), np.int32)
    for b in range(m.shape[1]):
        nz = np.flatnonzero(m[:, b])
        if len(nz) and (np.diff(nz) != 1).any():
            raise ValueError(f"band {b}'s bins are not contiguous")
        out[b] = (nz[0], nz[-1] + 1) if len(nz) else (0, 0)
    return out


@functools.lru_cache(maxsize=None)
def band_tables(device: str):
    """The band tables in the compact form the post-filter and the
    whole-chunk kernel read (each bin touches at most two neighbouring
    bands): (pairs [2, 481, 4] f32, band_pairs of the interpolation table
    ``tables.interp_matrix()`` (band values -> bins) and of the energy table
    ``tables.band_matrix()`` transposed (bins -> bands); ranges [32, 2]
    int32, band_ranges of the energy table)."""
    dense = {PAIR_INTERP: tables.interp_matrix(), PAIR_BAND: tables.band_matrix().T}
    pairs = np.stack([band_pairs(dense[i]) for i in range(len(dense))])
    return (torch.from_numpy(pairs).to(device),
            torch.from_numpy(band_ranges(dense[PAIR_BAND])).to(device))


@functools.lru_cache(maxsize=None)
def fft_tables(device: str) -> torch.Tensor:
    """The spectral kernels' twiddles [960 + 509, 2] f64: kernel_tables'
    base table, then the FFT's stage twiddles and roots
    (fft_plan.fft_table).  Every kernel of spectral.cu, analysis.cu and
    frame.cu takes it."""
    tw = kernel_tables("cpu")[1]
    plan = torch.from_numpy(fft_plan.fft_table(tw.numpy()))
    return torch.cat([tw, plan]).to(device)


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
        lib.rnnt_postfilter_synthesis.restype = i
        lib.rnnt_postfilter_synthesis.argtypes = [p] * 17 + [i, p]
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
    window, tw = kernel_tables(str(dev))[0], fft_tables(str(dev))
    X = torch.empty((S, 2 * FREQ_SIZE), dtype=f32, device=dev)
    P = torch.empty_like(X)
    p = kernels.ptr
    kernels.launch(_lib().rnnt_forward_spectral, "forward_spectral", dev,
                   p(mem), p(x), p(pitch_buf), p(start), p(window), p(tw),
                   p(X), p(P), S)
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
    window, tw = kernel_tables(str(dev))[0], fft_tables(str(dev))
    out = torch.empty((S, WINDOW_SIZE), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch(_lib().rnnt_inverse_spectral, "inverse_spectral", dev,
                   p(Y), p(window), p(tw), p(out), S)
    inverse_spectral.launches += 1
    return out


def postfilter_synthesis(dX, dP, dEx, dEp, dExp, g, lastg, Ex, silence,
                         synthesis_mem):
    """The delayed frame's post-filter and synthesis.  dX, dP: [S, 962] f32
    re|im; dEx, dEp, dExp, g, lastg, Ex: [S, 32] f32; silence: [S] bool;
    synthesis_mem: [S, 480] f32.  Returns (out [S, 480], synthesis_mem
    [S, 480], lastg [S, 32])."""
    if not dX.is_cuda:
        return postfilter_synthesis_plain(dX, dP, dEx, dEp, dExp, g, lastg, Ex,
                                          silence, synthesis_mem)
    S, dev, f32 = dX.shape[0], dX.device, torch.float32
    dX, dP, dEx, dEp, dExp, g, lastg, Ex, silence, synthesis_mem = (
        t.contiguous() for t in (dX, dP, dEx, dEp, dExp, g, lastg, Ex, silence,
                                 synthesis_mem))
    for name, t in (("dX", dX), ("dP", dP)):
        kernels.require(t, name, (S, 2 * FREQ_SIZE), f32, dev)
    for name, t in (("dEx", dEx), ("dEp", dEp), ("dExp", dExp), ("g", g),
                    ("lastg", lastg), ("Ex", Ex)):
        kernels.require(t, name, (S, NB_BANDS), f32, dev)
    kernels.require(silence, "silence", (S,), torch.bool, dev)
    kernels.require(synthesis_mem, "synthesis_mem", (S, FRAME_SIZE), f32, dev)
    window, tw = kernel_tables(str(dev))[0], fft_tables(str(dev))
    pairs, ranges = band_tables(str(dev))
    out = torch.empty((S, FRAME_SIZE), dtype=f32, device=dev)
    smem_out = torch.empty_like(out)
    lastg_out = torch.empty((S, NB_BANDS), dtype=f32, device=dev)
    p = kernels.ptr
    kernels.launch(
        _lib().rnnt_postfilter_synthesis, "postfilter_synthesis", dev,
        p(dX), p(dP), p(dEx), p(dEp), p(dExp), p(g), p(lastg), p(Ex),
        p(silence), p(synthesis_mem), p(pairs), p(ranges), p(window), p(tw),
        p(out), p(smem_out), p(lastg_out), S)
    postfilter_synthesis.launches += 1
    return out, smem_out, lastg_out


forward_spectral.launches = 0
inverse_spectral.launches = 0
postfilter_synthesis.launches = 0

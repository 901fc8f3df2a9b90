"""The whole chunk of the main path as one CUDA kernel (``csrc/frame.cu``) —
the port of ``rnnoise_tpu/dsp/pallas_frame.py:process_chunk_monokernel``.

One launch advances S streams by T frames: int16 PCM ``[T, S, 480]`` goes in
and int16 comes out, with the HP biquad, the pitch analysis, the band
features, the network's step and the post-filter with synthesis inside, and
the state carried from frame to frame within the launch.  The caller's
state is only read; the kernel writes a new one.

:func:`process_chunk_monokernel` launches the kernel for CUDA tensors and
uses :func:`process_chunk_monokernel_plain` for CPU tensors: the fused
configuration's chunk loop with every span in its plain version, which
rounds as the kernel does (the sums that decide a period, the silence gate
or an int8 activation in f64, rounded once).  The kernel has the default
numerics, the ratio ranking of pitch candidates and the "f64" HP-state
rounding only, and raises ``ValueError`` for a CUDA tensor with any other
configuration.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import kernels, tables
from ..config import (CONFIGURATIONS, FRAME_SIZE, FREQ_SIZE, NB_BANDS,
                      PITCH_BUF_SIZE, RuntimeConfig)
from ..denoise import DenoiseState, process_frames_tm_i16
from ..models.rnn import RNNState
from ..nn import cuda_rnn
from . import biquad, cuda_spectral
from .transform import device_table

MONO = CONFIGURATIONS["mono"]

# The HP biquad's Toeplitz term in csrc/frame.cu (HP_TILE there): a thread
# owns HP_TILE consecutive outputs of one stream, then the stream's mirror
# tile, so that every thread runs as many steps (biquad_tiles).
HP_TILE = 8

# The leaves of a DenoiseState in its field order (the network's state
# flattened): the order of State in csrc/frame.cu.
_STATE = ("analysis_mem", "synthesis_mem", "pitch_buf", "last_gain",
          "last_period", "mem_hp", "lastg", "conv1_mem", "conv2_mem", "gru1",
          "gru2", "gru3", "delayed_X", "delayed_P", "delayed_Ex",
          "delayed_Ep", "delayed_Exp")
_RNN = slice(7, 12)


class _State(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _STATE]


# The launch's arguments: the order of ChunkArgs in csrc/frame.cu.
_POINTERS = (("pcm", "out", "vad", "xp", "feats", "silence", "gains", "vad1")
             + cuda_rnn.PackedRNN._fields
             + ("hp_k", "hp_rowA", "hp_SA", "hp_SB", "window", "tw", "pairs",
                "ranges", "dct"))


class _ChunkArgs(ctypes.Structure):
    _fields_ = ([("src", _State), ("dst", _State), ("tmp", _State)]
                + [(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int) for n in ("S", "T", "F", "C", "N", "NB")])


def _leaves(state) -> list:
    return [*state[:7], *state.rnn, *state[8:]]


def _state(leaves):
    return DenoiseState(*leaves[:7], RNNState(*leaves[_RNN]), *leaves[12:])


def process_chunk_monokernel_plain(params, state, pcm: torch.Tensor,
                                   rt: RuntimeConfig = MONO):
    """Plain version of :func:`process_chunk_monokernel`: the fused
    configuration of ``rt`` with every span in its plain version."""
    fused = dataclasses.replace(rt, monokernel=False, analysis=True,
                                postfilter=True, xcorr=False)
    return process_frames_tm_i16(params, state, pcm, fused, plain=True)


def biquad_tiles(n: int = FRAME_SIZE, tile: int = HP_TILE) -> list:
    """The Toeplitz term's schedule for one stream, as csrc/frame.cu runs it:
    per thread, the first outputs i0 of its two tiles (tile p, then tile
    n / tile - 1 - p).  A tile's outputs i0 + r, r < tile, each sum
    k_d x[i0 + r - 1 - d] over the taps d = 0 .. i0 + tile - 2 in order, the
    samples before the frame read as zeros."""
    tiles = n // tile
    return [(p * tile, (tiles - 1 - p) * tile) for p in range(tiles // 2)]


def _check_config(params, rt: RuntimeConfig) -> None:
    """Raise ``ValueError`` unless the kernel computes ``rt``'s numerics."""
    if params is None:
        raise ValueError("the monokernel runs the network: params is None")
    if not (rt.quantized and rt.approx_act) or params.conv2.weights_q is None:
        raise ValueError(
            "the monokernel has the int8 / approx-activation numerics only; "
            "set monokernel=False for float weights or exact activations")
    if rt.exact_pitch_rank:
        raise ValueError(
            "the monokernel ranks pitch candidates by ratio: "
            "exact_pitch_rank=True needs monokernel=False")
    if rt.hp_rounding != "f64":
        raise ValueError(
            f"the monokernel rounds the HP-biquad state as 'f64': "
            f"hp_rounding={rt.hp_rounding!r} needs monokernel=False")


@functools.lru_cache(maxsize=None)
def _hp_tables(device: str):
    """The biquad's closed form in f64 (dsp/biquad.py): the input taps
    k [479], (A^i)[0, :] [480, 2], A^480 [2, 2] and A^{479-j} B [480, 2]."""
    b, a = (tuple(float(v) for v in np.asarray(c, np.float64))
            for c in (tables.BIQUAD_HP_B, tables.BIQUAD_HP_A))
    K, rowA, SA, SB = biquad._biquad_kernels(b, a, FRAME_SIZE)
    return tuple(torch.from_numpy(np.ascontiguousarray(m, np.float64)).to(device)
                 for m in (K[1:, 0], rowA, SA, SB))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kernels.library("frame")
        lib.rnnt_process_chunk.restype = ctypes.c_int
        lib.rnnt_process_chunk.argtypes = [ctypes.POINTER(_ChunkArgs),
                                           ctypes.c_void_p]
        _LIB = lib
    return _LIB


def process_chunk_monokernel(params, state, pcm: torch.Tensor,
                             rt: RuntimeConfig = MONO):
    """pcm [T, S, 480] int16 -> (new state, out [T, S, 480] int16,
    vad [T, S] f32) in one launch for CUDA tensors."""
    if not pcm.is_cuda:
        return process_chunk_monokernel_plain(params, state, pcm, rt)
    _check_config(params, rt)
    T, S, dev = pcm.shape[0], pcm.shape[1], pcm.device
    pk = cuda_rnn.packed_params(params)
    C, N = pk.conv1_b.shape[0], pk.conv2_b.shape[0]
    F, NB = pk.conv1_w.shape[0] // 3, pk.heads_b.shape[0] - 1
    if F != 2 * NB + 1 or NB != NB_BANDS or (3 * C) % 4 or N % cuda_rnn.BLOCK_OUT:
        raise ValueError(f"the monokernel needs {NB_BANDS} bands, 2 * bands "
                         "+ 1 features, 3 * cond a multiple of 4 and gru a "
                         f"multiple of {cuda_rnn.BLOCK_OUT}, not NB={NB}, "
                         f"F={F}, C={C}, N={N}")
    f32 = torch.float32
    pcm = pcm.contiguous()
    kernels.require(pcm, "pcm", (T, S, FRAME_SIZE), torch.int16, dev)
    cuda_rnn.require_packed(pk, F, C, N, NB, dev)
    src = [t.contiguous() for t in _leaves(state)]
    widths = (FRAME_SIZE, FRAME_SIZE, PITCH_BUF_SIZE, None, None, 2, NB,
              2 * F, 2 * C, N, N, N, 2 * FREQ_SIZE, 2 * FREQ_SIZE, NB, NB, NB)
    for name, t, w in zip(_STATE, src, widths):
        kernels.require(t, name, (S,) if w is None else (S, w),
                        torch.int32 if name == "last_period" else f32, dev)
    out = torch.empty((T, S, FRAME_SIZE), dtype=torch.int16, device=dev)
    vad = torch.empty((T, S), dtype=f32, device=dev)
    if T == 0:
        return state, out, vad
    dst = [torch.empty_like(t) for t in src]
    tmp = [None] * len(src)
    tmp[_RNN] = [torch.empty_like(t) for t in src[_RNN]]
    xp = torch.empty((2, S, 2 * FREQ_SIZE), dtype=f32, device=dev)
    feats = torch.empty((S, F), dtype=f32, device=dev)
    silence = torch.empty((S,), dtype=torch.uint8, device=dev)
    gains = torch.empty((S, NB), dtype=f32, device=dev)
    vad1 = torch.empty((S,), dtype=f32, device=dev)
    d = str(dev)
    window, tw = cuda_spectral.kernel_tables(d)[0], cuda_spectral.fft_tables(d)
    pairs, ranges = cuda_spectral.band_tables(d)

    def ptrs(ts):
        return _State(*(None if t is None else t.data_ptr() for t in ts))
    args = _ChunkArgs(
        ptrs(src), ptrs(dst), ptrs(tmp),
        *(t.data_ptr() for t in (pcm, out, vad, xp, feats, silence, gains, vad1,
                                 *pk, *_hp_tables(d), window, tw, pairs,
                                 ranges, device_table("dct", d))),
        S, T, F, C, N, NB)
    kernels.launch(_lib().rnnt_process_chunk, "process_chunk", dev,
                   ctypes.byref(args))
    process_chunk_monokernel.launches += 1
    return _state(dst), out, vad


process_chunk_monokernel.launches = 0

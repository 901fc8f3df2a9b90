"""Batched streaming denoiser core — the PyTorch counterpart of
``rnnoise_tpu/denoise.py`` (reference rnnoise_process_frame,
src/denoise.c:457-504).

The per-stream DenoiseState of the reference (denoise.c:68-88) becomes the
batched :class:`DenoiseState` with a leading ``[S]`` axis, and one call
advances all S streams by one 10 ms frame.  Silence follows the reference:
on silent frames the RNN state is left untouched and no gain or pitch
filtering is applied, but synthesis and the delayed-spectrum rotation still
happen — per-stream ``where`` masking instead of a branch.

On CUDA tensors kernels carry the frame, in one of the configurations of
``config.CONFIGURATIONS`` chosen by the RuntimeConfig: the forward spectra,
the RNN step and the inverse spectrum ("scan"; ``dsp/cuda_spectral.py``,
``nn/cuda_rnn.py``), plus the lag table ("xcorr"; ``dsp/cuda_xcorr.py``), or
the fused pitch analysis, the RNN step and the fused post-filter with
synthesis ("fused"; ``dsp/cuda_analysis.py``); or the int16 chunk entry
point runs the whole chunk as one kernel ("mono"; ``dsp/cuda_frame.py``).
``plain=True`` runs their plain PyTorch versions instead, to hold the
kernels against them.  Everything else is plain PyTorch on either device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import tables
from .config import (DEFAULT_MODEL, DEFAULT_RUNTIME, FRAME_SIZE, FREQ_SIZE,
                     ModelConfig, NB_BANDS, PITCH_BUF_SIZE, PITCH_MAX_PERIOD,
                     RuntimeConfig, SILENCE_THRESHOLD, WINDOW_SIZE,
                     resolve_device)
from .dsp import biquad as biquad_mod
from .dsp import cuda_analysis, cuda_spectral
from .dsp import pitch as pitch_mod
from .dsp.transform import (compute_band_corr, compute_band_energy, dct,
                            windowed_forward_transform)
from .models.rnn import ModelParams, RNNState, compute_rnn, init_rnn_state


class DenoiseState(NamedTuple):
    """Batched equivalent of the reference DenoiseState (denoise.c:68-88)."""

    analysis_mem: torch.Tensor      # [S, FRAME_SIZE]
    synthesis_mem: torch.Tensor     # [S, FRAME_SIZE]
    pitch_buf: torch.Tensor         # [S, PITCH_BUF_SIZE]
    last_gain: torch.Tensor         # [S]
    last_period: torch.Tensor       # [S] int32
    mem_hp: torch.Tensor            # [S, 2]
    lastg: torch.Tensor             # [S, NB_BANDS]
    rnn: RNNState
    delayed_X: torch.Tensor         # [S, 2*FREQ_SIZE] re|im, natural order
    delayed_P: torch.Tensor         # [S, 2*FREQ_SIZE]
    delayed_Ex: torch.Tensor        # [S, NB_BANDS]
    delayed_Ep: torch.Tensor        # [S, NB_BANDS]
    delayed_Exp: torch.Tensor       # [S, NB_BANDS]


def map_state(fn, state: DenoiseState, *others: DenoiseState) -> DenoiseState:
    """Apply ``fn`` leaf by leaf over one or more states (RNNState nested)."""
    fields = []
    for i, v in enumerate(state):
        if isinstance(v, RNNState):
            fields.append(RNNState(*(fn(a, *(o[i][j] for o in others))
                                     for j, a in enumerate(v))))
        else:
            fields.append(fn(v, *(o[i] for o in others)))
    return DenoiseState(*fields)


def init_state(n_streams: int, config: ModelConfig = DEFAULT_MODEL,
               device="cuda") -> DenoiseState:
    """Zero state for S streams (rnnoise_init, denoise.c:285-309) on
    ``device`` (for CUDA this also turns TF32 off, see resolve_device)."""
    S = n_streams
    device = resolve_device(device)

    def z(*shape, dtype=torch.float32):
        return torch.zeros((S,) + shape, dtype=dtype, device=device)
    return DenoiseState(
        analysis_mem=z(FRAME_SIZE), synthesis_mem=z(FRAME_SIZE),
        pitch_buf=z(PITCH_BUF_SIZE), last_gain=z(),
        last_period=z(dtype=torch.int32), mem_hp=z(2), lastg=z(NB_BANDS),
        rnn=init_rnn_state(S, config, device),
        delayed_X=z(2 * FREQ_SIZE), delayed_P=z(2 * FREQ_SIZE),
        delayed_Ex=z(NB_BANDS), delayed_Ep=z(NB_BANDS), delayed_Exp=z(NB_BANDS))


def reset_streams(state: DenoiseState, mask: torch.Tensor) -> DenoiseState:
    """Zero the streams where ``mask`` [S] is True and keep the others — the
    batched form of rnnoise_init on one stream (attach/detach)."""
    def blend(a):
        m = mask.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(m, torch.zeros_like(a), a)
    return map_state(blend, state)


class FrameFeatures(NamedTuple):
    X: torch.Tensor           # [S, 962] re|im
    P: torch.Tensor           # [S, 962] re|im
    Ex: torch.Tensor          # [S, NB_BANDS]
    Ep: torch.Tensor
    Exp: torch.Tensor
    features: torch.Tensor    # [S, NB_FEATURES]
    silence: torch.Tensor     # [S] bool


def _log_energy_follower(Ex: torch.Tensor) -> torch.Tensor:
    """The spectral-floor follower of denoise.c:381-388 over the 32 bands."""
    L = torch.log10(1e-2 + Ex)
    log_max = torch.full_like(L[:, 0], -2.0)
    follow = torch.full_like(L[:, 0], -2.0)
    cols = []
    for i in range(NB_BANDS):
        ly = torch.maximum(log_max - 7.0, torch.maximum(follow - 1.5, L[:, i]))
        log_max = torch.maximum(log_max, ly)
        follow = torch.maximum(follow - 1.5, ly)
        cols.append(ly)
    return torch.stack(cols, dim=-1)


def _lowpass(X: torch.Tensor, lowpass_bin: torch.Tensor) -> torch.Tensor:
    """X [S, 962] re|im with the bins at and above lowpass_bin [S] zeroed."""
    bins = torch.arange(FREQ_SIZE, device=X.device).repeat(2)
    return torch.where(bins[None, :] < lowpass_bin[:, None], X,
                       torch.zeros_like(X))


def compute_frame_features(state: DenoiseState, x: torch.Tensor,
                           rt: RuntimeConfig = DEFAULT_RUNTIME,
                           plain: bool = False, training: bool = False,
                           lowpass_bin: Optional[torch.Tensor] = None):
    """x: [S, FRAME_SIZE] HP-filtered PCM.  Returns the updated state
    (analysis mem, pitch buffer, pitch continuity) and this frame's
    features — rnn_compute_frame_features (denoise.c:347-398).

    ``training`` replicates the -DTRAINING build (denoise.c:340-343,
    389-397): the silence gate becomes E < 0.1 without clearing features;
    ``lowpass_bin`` [S] zeroes the bins of X at and above it (the
    data-augmentation hook).  Either, or ``rt.exact_pitch_rank``, runs the
    pitch chain in PyTorch with the forward-spectrum kernel, as the JAX
    package does."""
    pitch_buf = torch.cat([state.pitch_buf[:, FRAME_SIZE:], x], dim=-1)
    ds = pitch_mod.pitch_downsample(pitch_buf)
    if rt.analysis and not (rt.exact_pitch_rank or training
                            or lowpass_bin is not None):
        # fine search, doubling ladder, window and both forward spectra in
        # one kernel; only the coarse search stays outside
        bp0, bp1 = pitch_mod.coarse_search(ds)
        analysis = (cuda_analysis.analysis_spectral_plain if plain
                    else cuda_analysis.analysis_spectral)
        X, P, T0, gain = analysis(state.analysis_mem, x, pitch_buf, ds, bp0,
                                  bp1, state.last_period, state.last_gain)
    else:
        # shared by fine search + doubling
        bx = pitch_mod.lag_corr_table(ds, rt.xcorr, plain)
        pitch = pitch_mod.pitch_search(ds, bx, rt.exact_pitch_rank)
        T0, gain = pitch_mod.remove_doubling(ds, PITCH_MAX_PERIOD - pitch,
                                             state.last_period,
                                             state.last_gain, bx)
        # pitch-delayed window p[i] = pitch_buf[PITCH_BUF_SIZE-WINDOW_SIZE-T0+i]
        start = PITCH_BUF_SIZE - WINDOW_SIZE - T0
        forward = (cuda_spectral.forward_spectral_plain if plain
                   else cuda_spectral.forward_spectral)
        X, P = forward(state.analysis_mem, x, pitch_buf, start)
        if lowpass_bin is not None:
            X = _lowpass(X, lowpass_bin)
    Ex = compute_band_energy(X)
    Ep = compute_band_energy(P)
    Exp = compute_band_corr(X, P) / torch.sqrt(0.001 + Ex * Ep)

    Ly = _log_energy_follower(Ex)
    E = Ex.double().sum(dim=-1).float()       # f64, as for the band sums
    f_bfcc = dct(Ly)
    f_bfcc = torch.cat([f_bfcc[:, :1] + -12.0, f_bfcc[:, 1:2] + -4.0,
                        f_bfcc[:, 2:]], dim=-1)
    f_corr = dct(Exp)
    f_pitch = 0.01 * (T0.float() - 300.0)
    features = torch.cat([f_bfcc, f_corr, f_pitch[:, None]], dim=-1)
    if training:
        silence = E < 0.1
    else:
        silence = E < SILENCE_THRESHOLD
        features = torch.where(silence[:, None], torch.zeros_like(features),
                               features)
    new_state = state._replace(analysis_mem=x, pitch_buf=pitch_buf,
                               last_period=T0, last_gain=gain)
    return new_state, FrameFeatures(X, P, Ex, Ep, Exp, features, silence)


def _frame_analysis(analysis_mem: torch.Tensor, x: torch.Tensor,
                    lowpass_bin: Optional[torch.Tensor] = None):
    """The analysis alone (the reference's rnn_frame_analysis): the
    windowed forward spectrum of [analysis_mem | x] and its band energies,
    with the bins at and above ``lowpass_bin`` [S] zeroed when given.
    Returns (new analysis_mem, X [S, 962] re|im, Ex [S, 32]).

    X is the f64 transform of ``forward_spectral_plain`` rounded once, on
    either device: training's clean path has no pitch window, so a launch
    of the forward kernel would compute a second spectrum to discard."""
    X = windowed_forward_transform(torch.cat([analysis_mem, x], dim=-1))
    if lowpass_bin is not None:
        X = _lowpass(X, lowpass_bin)
    return x, X, compute_band_energy(X)


def process_frame(params: Optional[ModelParams], state: DenoiseState,
                  pcm: torch.Tensor, rt: RuntimeConfig = DEFAULT_RUNTIME,
                  plain: bool = False):
    """Advance all streams by one frame.

    pcm: [S, FRAME_SIZE] float PCM in int16 scale.  Returns (new_state,
    out_pcm [S, FRAME_SIZE], vad [S]).  ``params=None`` runs the DSP path
    with unity gains (no model)."""
    x, mem_hp = biquad_mod.biquad(pcm, state.mem_hp, tables.BIQUAD_HP_B,
                                  tables.BIQUAD_HP_A, rt.hp_rounding)
    return _process_frame_hp(params, state._replace(mem_hp=mem_hp), x, rt,
                             plain)


def _process_frame_hp(params, state, x, rt, plain):
    """process_frame after the HP biquad (x already filtered)."""
    state, ff = compute_frame_features(state, x, rt, plain)
    silence = ff.silence
    S = x.shape[0]
    if params is not None:
        # silent frames freeze the RNN state and zero the VAD (compute_rnn
        # is skipped in C) — applied inside the step
        rnn_state, g, vad = compute_rnn(params, state.rnn, ff.features, rt,
                                        silence=silence, plain=plain)
    else:
        rnn_state = state.rnn
        g = torch.ones((S, NB_BANDS), dtype=torch.float32, device=x.device)
        vad = torch.zeros((S,), dtype=torch.float32, device=x.device)

    # pitch-filter and apply the gains to the *previous* frame's spectrum,
    # then synthesis
    tail = (state.delayed_X, state.delayed_P, state.delayed_Ex,
            state.delayed_Ep, state.delayed_Exp, g, state.lastg, ff.Ex,
            silence, state.synthesis_mem)
    if rt.postfilter and not plain:
        out, synthesis_mem, lastg = cuda_spectral.postfilter_synthesis(*tail)
    else:
        out, synthesis_mem, lastg = cuda_spectral.postfilter_chain(*tail, plain)

    new_state = state._replace(
        synthesis_mem=synthesis_mem, lastg=lastg, rnn=rnn_state,
        delayed_X=ff.X, delayed_P=ff.P,
        delayed_Ex=ff.Ex, delayed_Ep=ff.Ep, delayed_Exp=ff.Exp)
    return new_state, out, vad


def process_frames_tm(params: Optional[ModelParams], state: DenoiseState,
                      pcm: torch.Tensor, rt: RuntimeConfig = DEFAULT_RUNTIME,
                      plain: bool = False):
    """Time-major chunk: pcm [T, S, FRAME_SIZE] -> (new_state,
    out [T, S, FRAME_SIZE], vad [T, S]).  The HP biquad runs once over the
    whole chunk; the rest of the frame steps frame by frame."""
    x_hp, mem_hp = biquad_mod.biquad_frames(pcm, state.mem_hp,
                                            tables.BIQUAD_HP_B,
                                            tables.BIQUAD_HP_A, rt.hp_rounding)
    state = state._replace(mem_hp=mem_hp)
    outs, vads = [], []
    for x in x_hp:
        state, out, vad = _process_frame_hp(params, state, x, rt, plain)
        outs.append(out)
        vads.append(vad)
    return state, torch.stack(outs), torch.stack(vads)


def process_frames(params: Optional[ModelParams], state: DenoiseState,
                   pcm: torch.Tensor, rt: RuntimeConfig = DEFAULT_RUNTIME,
                   plain: bool = False):
    """pcm [S, T, FRAME_SIZE] -> (new_state, out [S, T, FRAME_SIZE],
    vad [S, T])."""
    state, out, vad = process_frames_tm(params, state, pcm.transpose(0, 1),
                                        rt, plain)
    return state, out.transpose(0, 1), vad.transpose(0, 1)


def process_frames_tm_i16(params: Optional[ModelParams], state: DenoiseState,
                          pcm: torch.Tensor,
                          rt: RuntimeConfig = DEFAULT_RUNTIME,
                          plain: bool = False):
    """Int16 at the boundary: pcm [T, S, FRAME_SIZE] int16 -> (state,
    out int16, vad).  Rounding is the native ring's float path: half away
    from zero, clipped to int16 (streamio.cc Ring::push_f32).  With
    ``rt.monokernel`` the chunk is one launch of the whole-chunk kernel
    (its plain version on CPU tensors or with ``plain``).  That kernel runs
    an int8 network, so without a model (``params=None``, unity gains) or
    with a float-only one the chunk runs the frame loop of ``rt``'s fused
    configuration instead, with its kernels, as the JAX package falls back
    from its monokernel (its ``_monokernel_viable``)."""
    if rt.monokernel and (params is None or params.conv2.weights_q is None):
        rt = dataclasses.replace(rt, monokernel=False)
    if rt.monokernel:
        from .dsp import cuda_frame
        run = (cuda_frame.process_chunk_monokernel_plain if plain
               else cuda_frame.process_chunk_monokernel)
        return run(params, state, pcm, rt)
    state, out, vad = process_frames_tm(params, state, pcm.float(), rt, plain)
    rounded = torch.trunc(torch.where(out > 0, out + 0.5, out - 0.5))
    out_i16 = torch.clamp(rounded, -32768.0, 32767.0).to(torch.int16)
    return state, out_i16, vad

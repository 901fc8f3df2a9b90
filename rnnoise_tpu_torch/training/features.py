"""Training-data generation — the PyTorch counterpart of
``rnnoise_tpu/training/features.py`` (reference src/dump_features.c).

Per 2000-frame (20 s) sequence: random excerpts of speech / background noise /
foreground noise, random spectral tilt biquads, random gains, random lowpass,
Viterbi VAD gating with fades, A-weighted RMS normalisation, optional RIR
convolution and clip/quantisation (``tools/dump_features.py``,
``augment.py``) — then the **same feature extractor the inference runtime
uses** (preserving the shared-extractor property of SURVEY.md §3.4) to
produce 98-float records [65 features | 32 gain targets | 1 vad].

The augmentation runs in numpy/scipy per sequence; the feature extraction
runs on the tensors' device, a loop over frames with a [B] sequence axis
(on CUDA tensors its forward spectra are the forward-spectrum kernel's).
The targets and the RIR helpers are numpy copies of the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import FRAME_SIZE, NB_BANDS
from ..denoise import _frame_analysis, compute_frame_features, init_state
from ..tables import EBAND20MS

RIR_FFT_SIZE = 65536
RIR_MAX_DURATION = RIR_FFT_SIZE // 2


# ---------------------------------------------------------------------------
# batched feature extraction (on the tensors' device)
# ---------------------------------------------------------------------------

def _sequence_features(clean: torch.Tensor, noisy: torch.Tensor,
                       lowpass_bin: torch.Tensor):
    """clean/noisy: [B, T*480] float PCM; lowpass_bin: [B] int32, all on one
    device.

    Returns (Ey[B,T,32], Ex[B,T,32], features[B,T,65], silence[B,T]).
    Mirrors the dump_features per-frame loop (dump_features.c:466-469): the
    clean path runs the frame analysis only, the noisy path the full feature
    extractor, both with the TRAINING lowpass augmentation."""
    B = clean.shape[0]
    T = clean.shape[1] // FRAME_SIZE
    clean_f = clean.reshape(B, T, FRAME_SIZE)
    noisy_f = noisy.reshape(B, T, FRAME_SIZE)
    nstate = init_state(B, device=clean.device)
    cmem = torch.zeros((B, FRAME_SIZE), dtype=torch.float32,
                       device=clean.device)
    Ey, Ex, feats, silence = [], [], [], []
    for t in range(T):
        cmem, _, ey = _frame_analysis(cmem, clean_f[:, t], lowpass_bin)
        nstate, ff = compute_frame_features(nstate, noisy_f[:, t],
                                            training=True,
                                            lowpass_bin=lowpass_bin)
        Ey.append(ey)
        Ex.append(ff.Ex)
        feats.append(ff.features)
        silence.append(ff.silence)
    return tuple(torch.stack(a, dim=1) for a in (Ey, Ex, feats, silence))


def compute_targets(Ey, Ex, silence, vad, band_lp, noise_free):
    """Per-band gain targets with don't-care marking
    (dump_features.c:471-478).  All numpy.

    Ey/Ex: [B,T,32]; silence: [B,T]; vad: [B,T]; band_lp: [B];
    noise_free: [B] (noise_gain==0 and fgnoise_gain==0)."""
    g = np.sqrt((Ey + 1e-3) / (Ex + 1e-3)).astype(np.float32)
    g = np.minimum(g, 1.0)
    bands = np.arange(NB_BANDS)[None, None, :]
    dont_care = (silence[:, :, None]
                 | (bands > band_lp[:, None, None])
                 | ((Ey < 5e-2) & (Ex < 5e-2))
                 | ((vad[:, :, None] == 0) & noise_free[:, None, None]))
    g[dont_care] = -1.0
    return g


def band_lp_from_lowpass(lowpass_bin: np.ndarray) -> np.ndarray:
    """First band whose lower edge exceeds the lowpass bin; NB_BANDS if none.

    NOTE: the reference keeps a sticky global here (band_lp retains the
    previous sequence's value when no band exceeds — dump_features.c:46,
    401-406); we use the evident intent (no bands masked for full-band
    sequences) instead.
    """
    edges = np.asarray(EBAND20MS[:NB_BANDS])
    out = np.full(lowpass_bin.shape, NB_BANDS, np.int32)
    for i, lp in enumerate(lowpass_bin):
        above = np.nonzero(edges > lp)[0]
        if above.size:
            out[i] = above[0]
    return out


# ---------------------------------------------------------------------------
# RIR support (65536-pt overlap-save convolution, dump_features.c:51-144)
# ---------------------------------------------------------------------------

class RIRList(NamedTuple):
    rir: np.ndarray      # [N, RIR_FFT_SIZE] complex128 spectra (full)
    early: np.ndarray    # [N, RIR_FFT_SIZE] complex128 spectra (early-tapered)


def load_rir(path: str) -> tuple[np.ndarray, np.ndarray]:
    rir = np.fromfile(path, dtype=np.float32, count=RIR_MAX_DURATION)
    full = np.zeros(RIR_FFT_SIZE, np.float32)
    full[:rir.shape[0]] = rir
    early = full.copy()
    n_taper = min(240, max(0, rir.shape[0] - 480))
    if rir.shape[0] > 480:
        taper = 1.0 - np.arange(240, dtype=np.float32) / 240.0
        early[480:480 + n_taper] *= taper[:n_taper]
        early[480 + 240:] = 0.0
    return np.fft.fft(full), np.fft.fft(early)


def load_rir_list(list_file: str) -> RIRList:
    fulls, earlies = [], []
    with open(list_file) as f:
        for line in f:
            line = line.strip()
            if line:
                fu, ea = load_rir(line)
                fulls.append(fu)
                earlies.append(ea)
    return RIRList(np.stack(fulls), np.stack(earlies))


def rir_filter_sequence(audio: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Overlap-save block convolution with spectrum Y
    (dump_features.c:119-144): 32768-sample hops through a 65536-pt FFT.

    The reference's scaling chain (1/N forward FFT twice, x N/2 in the
    product, unscaled inverse) nets out to circular_conv(x, rir) / 2."""
    half = RIR_FFT_SIZE // 2
    x = np.zeros(RIR_FFT_SIZE)
    out = audio.astype(np.float64).copy()
    i = 0
    while i < audio.shape[0]:
        n = min(audio.shape[0] - i, half)
        x[:half] = x[half:]
        x[half:half + n] = out[i:i + n]
        x[half + n:] = 0.0
        y = np.real(np.fft.ifft(np.fft.fft(x) * Y)) * 0.5
        out[i:i + n] = y[half:half + n]
        i += half
    return out.astype(np.float32)

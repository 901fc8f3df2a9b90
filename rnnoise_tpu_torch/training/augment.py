"""Augmentation primitives for training-data generation — port of the
random-filter / VAD / RMS machinery in src/dump_features.c.

These run per-sequence at data-generation time.  Random draws use a numpy
Generator instead of C's pid-seeded rand() (the reference is deliberately
non-reproducible across runs — dump_features.c:316); the *distributions* are
replicated exactly.

A copy of ``rnnoise_tpu/training/augment.py`` (numpy and scipy only), kept
here so the port never imports the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SEQUENCE_LENGTH = 2000
FRAME_SIZE = 480
SEQUENCE_SAMPLES = SEQUENCE_LENGTH * FRAME_SIZE

# Viterbi VAD constants (dump_features.c:193-197)
_P00 = _P11 = 0.99
_P01 = _P10 = 0.01
_LOGIT_SCALE = 0.5


def rand_filt(rng: np.random.Generator) -> np.ndarray:
    """One random biquad denominator/numerator pair half
    (dump_features.c:159-178): 2/3 identity, else conjugate poles or two real
    zeros."""
    if rng.integers(3) != 0:
        return np.zeros(2, np.float32)
    if rng.random() - 0.5 > 0:
        r = rng.random()
        r = 0.7 * r * r
        theta = rng.random()
        theta = np.pi * theta * theta
        return np.array([-2 * r * np.cos(theta), r * r], np.float32)
    r0 = 1.4 * (rng.random() - 0.5)
    r1 = 1.4 * (rng.random() - 0.5)
    return np.array([-r0 - r1, r0 * r1], np.float32)


def rand_resp(rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(a, b) random spectral-tilt biquad (dump_features.c:180-183)."""
    return rand_filt(rng), rand_filt(rng)


def viterbi_vad(E: np.ndarray) -> np.ndarray:
    """2-state Viterbi VAD from per-frame speech energies with hangover
    (dump_features.c:199-254).  E: [T] -> vad [T] int."""
    T = E.shape[0]
    Esig = np.sqrt((1e-30 + np.sum(E.astype(np.float64) ** 2)) / T)
    Enoise = 1.0 / np.sqrt(
        (1e-30 + np.sum(1.0 / (1e-8 * Esig * Esig + E.astype(np.float64) ** 2)))
        / T)

    p0 = (np.log(1e-15 + E) - np.log(Enoise)) / \
         (0.01 + np.log(Esig) - np.log(Enoise))
    p0 = np.clip(p0, 0.1, 0.9)
    p0 = 1.0 / (1.0 + ((1.0 - p0) / p0) ** _LOGIT_SCALE)

    back = np.zeros((T, 2), np.int32)
    curr = 0.5
    for i in range(T):
        if curr * _P11 > (1 - curr) * _P01:
            back[i, 1] = 1
            prior_s = curr * _P11
        else:
            back[i, 1] = 0
            prior_s = (1 - curr) * _P01
        pspeech = prior_s * p0[i]
        if (1 - curr) * _P00 > curr * _P10:
            back[i, 0] = 0
            prior_n = (1 - curr) * _P00
        else:
            back[i, 0] = 1
            prior_n = curr * _P10
        pnoise = prior_n * (1 - p0[i])
        curr = pspeech / (pspeech + pnoise)

    vad = np.zeros(T, np.int32)
    vad[T - 1] = int(curr > 0.5)
    for i in range(T - 2, -1, -1):
        vad[i] = back[i + 1, vad[i + 1]]
    # hangover both directions (dump_features.c:248-253)
    for i in range(T - 1):
        if vad[i + 1]:
            vad[i] = 1
    for i in range(T - 1, 0, -1):
        if vad[i - 1]:
            vad[i] = 1
    return vad


def clear_vad(x: np.ndarray, vad: np.ndarray) -> np.ndarray:
    """Zero inactive stretches with linear fade in/out
    (dump_features.c:256-281).  x: [T*480] modified copy returned."""
    x = x.copy()
    T = vad.shape[0]
    ramp = np.arange(FRAME_SIZE, dtype=np.float32) / FRAME_SIZE
    active = bool(vad[0])
    for i in range(T):
        sl = slice(i * FRAME_SIZE, (i + 1) * FRAME_SIZE)
        if not active:
            if i < T - 1 and vad[i + 1]:
                x[sl] *= ramp
                active = True
            else:
                x[sl] = 0.0
        else:
            if i >= 1 and vad[i] == 0 and vad[i - 1] == 0:
                x[sl] *= 1.0 - ramp
                active = False
    return x


def weighted_rms(x: np.ndarray) -> float:
    """A-weighting-ish RMS (dump_features.c:283-293) — biquad
    b=[-2,1], a=[-1.89,.895] then RMS * 0.9506."""
    b = np.array([-2.0, 1.0])
    a = np.array([-1.89, 0.895])
    # direct-form II transposed, f64 accumulators like rnn_biquad
    m0 = m1 = 0.0
    # vectorised lfilter-free implementation via scipy-style recursion in
    # blocks would still be sequential; use the exact recurrence in numpy.
    y = np.empty_like(x, dtype=np.float64)
    xi = x.astype(np.float64)
    # y[i] = x[i] + m0; m0 = m1 + b0 x - a0 y; m1 = b1 x - a1 y
    for i in range(x.shape[0]):
        v = xi[i]
        yi = v + m0
        m0 = m1 + (b[0] * v - a[0] * yi)
        m1 = b[1] * v - a[1] * yi
        y[i] = yi
    mse = 1e-15 + np.sum(y * y)
    return float(0.9506 * np.sqrt(mse / x.shape[0]))


def weighted_rms_fast(x: np.ndarray) -> float:
    """Vectorised weighted_rms using scipy if available, else the exact
    loop."""
    try:
        from scipy.signal import lfilter
        y = lfilter([1.0, -2.0, 1.0], [1.0, -1.89, 0.895], x.astype(np.float64))
        mse = 1e-15 + np.sum(y * y)
        return float(0.9506 * np.sqrt(mse / x.shape[0]))
    except ImportError:
        return weighted_rms(x)

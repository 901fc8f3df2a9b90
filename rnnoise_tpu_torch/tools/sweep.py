"""Exponential (Farina) sweep generation for room impulse response
measurement.

Role parity: the reference ships a sweep generator whose output is played
through a speaker and re-recorded to measure RIRs for training-data
augmentation (scripts/sweep.py; consumed by scripts/rir_deconv.py).  This is
an original implementation built on the standard Farina method [Farina 2000,
"Simultaneous measurement of impulse response and distortion with a
swept-sine technique"]:

  x(t) = sin( K * (e^{t/L} - 1) ),   L = T / ln(f1/f0),   K = 2*pi*f0*L

The Farina sweep admits an *analytic inverse filter* — the time-reversed
sweep with a +6 dB/octave amplitude tilt — so deconvolution is a plain
convolution that places harmonic-distortion images strictly BEFORE the
linear impulse response (they can be cropped off), rather than the
regularised spectral division the reference uses.

The measurement session layout keeps the reference's robust structure
(pilot chirps bracketing the sweep for synchronisation and clock-drift
estimation) but everything is parameterised:

    [silence | pilot | silence | sweep | silence | pilot | silence]

A copy of ``rnnoise_tpu/tools/sweep.py``: host code on numpy in f64, the
same arithmetic in the same order, so its sessions equal the JAX package's
bit for bit.

Usage: python -m rnnoise_tpu_torch.tools.sweep out.wav [duration_s]
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SweepSpec:
    """Parameters of one measurement session."""

    fs: int = 48000
    f0: float = 100.0           # sweep start (Hz)
    f1: float = 0.0             # sweep end; 0 -> Nyquist
    duration: float = 60.0      # sweep length (s)
    pilot_duration: float = 1.0  # sync chirp length (s)
    gap: float = 1.0            # silence between segments (s)
    amplitude: float = 0.5      # headroom against speaker/mic clipping
    fade: float = 0.005         # raised-cosine fade-in/out (s)

    @property
    def nyquist(self) -> float:
        return self.f1 if self.f1 > 0 else self.fs / 2.0

    @property
    def sweep_len(self) -> int:
        return int(round(self.duration * self.fs))

    @property
    def pilot_len(self) -> int:
        return int(round(self.pilot_duration * self.fs))

    @property
    def gap_len(self) -> int:
        return int(round(self.gap * self.fs))

    @property
    def pilot_spacing(self) -> int:
        """Samples between the onsets of the two pilots."""
        return self.pilot_len + 2 * self.gap_len + self.sweep_len


def _fade_envelope(n: int, fade_n: int) -> np.ndarray:
    env = np.ones(n)
    if fade_n > 0:
        ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(fade_n) / fade_n)
        env[:fade_n] = ramp
        env[-fade_n:] = ramp[::-1]
    return env


def exp_sweep(spec: SweepSpec, duration: float | None = None) -> np.ndarray:
    """Farina sweep at unit amplitude, raised-cosine faded at both ends."""
    T = spec.duration if duration is None else duration
    n = int(round(T * spec.fs))
    t = np.arange(n) / spec.fs
    L = T / np.log(spec.nyquist / spec.f0)
    x = np.sin(2.0 * np.pi * spec.f0 * L * (np.exp(t / L) - 1.0))
    return x * _fade_envelope(n, int(round(spec.fade * spec.fs)))


def inverse_filter(spec: SweepSpec) -> np.ndarray:
    """Analytic Farina inverse: time-reversed sweep, amplitude-modulated by
    e^{-t/L} (a +6 dB/octave tilt over the sweep), scaled so that
    conv(sweep, inverse) approximates a unit impulse at lag sweep_len."""
    T = spec.duration
    n = spec.sweep_len
    t = np.arange(n) / spec.fs
    L = T / np.log(spec.nyquist / spec.f0)
    x = exp_sweep(spec)
    mod = np.exp(-t / L)
    inv = x[::-1] * mod
    # normalise: the sweep's autoconvolution with inv should peak at 1
    peak = np.sum(x * inv[::-1])
    return inv / peak


def pilot_chirp(spec: SweepSpec) -> np.ndarray:
    """Short full-band linear chirp with sharp autocorrelation, used twice
    per session for sync + drift measurement."""
    n = spec.pilot_len
    t = np.arange(n) / spec.fs
    k = (spec.nyquist * 0.9 - spec.f0) / spec.pilot_duration
    x = np.sin(2.0 * np.pi * (spec.f0 * t + 0.5 * k * t * t))
    return x * _fade_envelope(n, int(round(spec.fade * spec.fs)))


def measurement_sequence(spec: SweepSpec) -> np.ndarray:
    """The full playable session as int16 PCM."""
    z = np.zeros(spec.gap_len)
    seq = np.concatenate([z, pilot_chirp(spec), z, exp_sweep(spec), z,
                          pilot_chirp(spec), z]) * spec.amplitude
    return np.round(32767.0 * seq).astype(np.int16)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    duration = float(argv[1]) if len(argv) > 1 else 60.0
    spec = SweepSpec(duration=duration)
    from scipy.io import wavfile
    wavfile.write(argv[0], spec.fs, measurement_sequence(spec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

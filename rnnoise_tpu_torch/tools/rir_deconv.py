"""Room-impulse-response recovery from a recorded sweep session.

Role parity: the reference deconvolves a re-recorded log sweep into an RIR
for training-data augmentation (scripts/rir_deconv.py).  Original method,
built around the Farina analytic inverse filter from tools/sweep.py:

 1. SYNC — matched-filter the recording against the pilot chirp; the two
    strongest, sufficiently-separated correlation peaks locate both pilots.
 2. DRIFT — the deviation of the measured peak spacing from the nominal
    spacing IS the accumulated clock drift; the sweep segment is resampled
    by that linear factor (the reference instead truncates by the drift).
 3. DECONVOLVE — convolve the synchronised sweep segment with the analytic
    inverse filter.  The linear RIR lands at a known lag; harmonic
    distortion products land strictly earlier and are cropped away (this
    separation is the point of the Farina method — no regularised spectral
    division, no 1/(1+|X|^2) bias).
 4. TRIM — onset at the first arrival above 1/50 of the direct peak; tail
    where the Schroeder backward energy integral falls below the noise
    floor measured from the pre-onset noise.
 5. Normalise to unit energy.

A copy of ``rnnoise_tpu/tools/rir_deconv.py``: host code on numpy and
scipy in f64, bit for bit the JAX package's.  The RIR is written as raw
f32, the format ``training.features.load_rir`` reads (``-rir_list`` of
``tools.dump_features``).

Usage: python -m rnnoise_tpu_torch.tools.rir_deconv recorded.wav \
           out_rir.f32 [duration_s]
"""

from __future__ import annotations

import sys

import numpy as np

from .sweep import SweepSpec, inverse_filter, pilot_chirp


def locate_pilots(y: np.ndarray, spec: SweepSpec) -> tuple[int, int]:
    """Positions (sample onsets) of the two pilot chirps in the recording,
    via matched filtering.  The second pilot is searched in a window around
    its nominal offset from the first so a loud late reflection cannot
    masquerade as it."""
    from scipy.signal import fftconvolve
    p = pilot_chirp(spec)
    corr = np.abs(fftconvolve(y, p[::-1], mode="valid"))
    spacing = spec.pilot_spacing
    first_region = corr[: max(1, len(corr) - spacing)]
    pos1 = int(np.argmax(first_region))
    lo = pos1 + spacing - spec.gap_len // 2
    hi = min(len(corr), pos1 + spacing + spec.gap_len // 2)
    if lo >= len(corr):
        raise ValueError("recording too short for the second pilot")
    pos2 = lo + int(np.argmax(corr[lo:hi]))
    return pos1, pos2


def extract_sweep_segment(y: np.ndarray, spec: SweepSpec) -> np.ndarray:
    """Synchronised, drift-compensated sweep segment (with half a gap of
    context on each side so early reflections and onset are preserved)."""
    from scipy.signal import resample
    pos1, pos2 = locate_pilots(y, spec)
    drift = (pos2 - pos1) - spec.pilot_spacing     # + = recording clock slow
    # half a gap of pre-roll + sweep + 3/4 gap of tail: stops short of the
    # second pilot, whose deconvolution image would pollute the RIR tail.
    total = spec.gap_len // 2 + spec.sweep_len + (3 * spec.gap_len) // 4 \
        + abs(drift)
    start = pos1 + spec.pilot_len + spec.gap_len // 2
    seg = np.asarray(y[start:start + total], dtype=np.float64)
    print(f"pilot spacing {pos2 - pos1} samples, drift {drift} "
          f"({100.0 * drift / spec.pilot_spacing:.4f}%)")
    if drift != 0:
        # Linear clock-rate correction: stretch the whole segment by the
        # measured ratio so the sweep matches the reference excitation.
        n_target = int(round(len(seg) * spec.pilot_spacing
                             / (spec.pilot_spacing + drift)))
        seg = resample(seg, n_target)
    return seg


def deconvolve(seg: np.ndarray, spec: SweepSpec) -> np.ndarray:
    """Convolve with the analytic inverse filter and keep the causal part.

    In conv(seg, inv), the linear RIR starts at lag (sweep_len - 1 +
    gap_len/2 - pre-roll); everything earlier holds harmonic-distortion
    images and is discarded."""
    from scipy.signal import fftconvolve
    h = fftconvolve(seg, inverse_filter(spec))
    # seg begins gap_len/2 before the sweep onset; the impulse of a perfect
    # loopback therefore lands at sweep_len - 1 + gap_len/2.  Keep a short
    # pre-roll for the onset detector.
    pre_roll = spec.gap_len // 4
    t0 = spec.sweep_len - 1 + spec.gap_len // 2 - pre_roll
    return h[t0:t0 + spec.gap_len + spec.sweep_len // 4]


def trim_rir(h: np.ndarray, spec: SweepSpec,
             onset_ratio: float = 0.02,
             tail_margin_db: float = 10.0) -> np.ndarray:
    """Crop to [first arrival, noise floor] and normalise to unit energy.

    Tail: Schroeder backward integration E[n] = sum_{m>=n} h[m]^2 decays
    linearly (in dB) for a diffuse tail; the RIR ends where E drops within
    ``tail_margin_db`` of the measurement's noise energy (estimated from
    the pre-onset samples)."""
    a = np.abs(h)
    direct = int(np.argmax(a))
    peak = a[direct]
    onset_candidates = np.nonzero(a[:direct + 1] >= onset_ratio * peak)[0]
    onset = int(onset_candidates[0]) if len(onset_candidates) else direct

    noise_pow = float(np.mean(h[:max(1, onset - spec.fs // 100)] ** 2)) \
        if onset > spec.fs // 100 else 0.0
    tail = h[onset:]
    edc = np.cumsum(tail[::-1] ** 2)[::-1]          # Schroeder integral
    if noise_pow > 0:
        # Cut at the first point where the REMAINING energy over the
        # remaining support is indistinguishable from measurement noise
        # (within tail_margin_db) — keeping everything after that only adds
        # noise to the estimate.
        n_left = np.arange(len(edc), 0, -1)
        margin = 10.0 ** (tail_margin_db / 10.0)
        below = np.nonzero(edc <= margin * noise_pow * n_left)[0]
        end = max(int(below[0]), 1) if len(below) else len(tail)
    else:
        end = len(tail)
    rir = tail[:end]
    return rir / np.sqrt(np.sum(rir ** 2))


def measure_rir(recording: np.ndarray, spec: SweepSpec) -> np.ndarray:
    """Full pipeline: recorded session -> trimmed, unit-energy RIR."""
    seg = extract_sweep_segment(recording, spec)
    return trim_rir(deconvolve(seg, spec), spec)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 1
    from scipy.io import wavfile
    duration = float(argv[2]) if len(argv) > 2 else 60.0
    spec = SweepSpec(duration=duration)
    fs, mic = wavfile.read(argv[0])
    if fs != spec.fs:
        raise ValueError(f"expected {spec.fs} Hz recording, got {fs}")
    if mic.ndim > 1:
        mic = mic[:, 0]
    rir = measure_rir(mic.astype(np.float64), spec)
    rir.astype(np.float32).tofile(argv[1])
    print(f"wrote {len(rir)} samples ({len(rir) / spec.fs:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""dump_features CLI — training-data generator (reference src/dump_features.c,
usage dump_features.c:329):

    python -m rnnoise_tpu_torch.tools.dump_features [-rir_list list] \
        [--device cuda|cpu] <speech.pcm> <noise.pcm> <fg_noise.pcm> \
        <output.f32> <count>

Inputs are raw 16-bit 48 kHz mono PCM; output is the features.f32 stream of
98-float records consumed by training.  Sequences are generated in batches,
augmented in numpy on the host, with the feature extraction running on
``device`` (the GPU unless the caller names another).  The PyTorch
counterpart of ``rnnoise_tpu/tools/dump_features.py``, with the same
command line plus ``--device``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

import torch

from ..config import FRAME_SIZE, FREQ_SIZE, resolve_device
from ..tables import BIQUAD_HP_A, BIQUAD_HP_B
from ..training.augment import (SEQUENCE_LENGTH, clear_vad, rand_resp,
                                viterbi_vad, weighted_rms_fast)
from ..training.features import (RIRList, _sequence_features,
                                 band_lp_from_lowpass, compute_targets,
                                 load_rir_list, rir_filter_sequence)


def _biquad_f64(x, b, a):
    """Offline augmentation biquads (dump_features.c:420-431) — scipy lfilter
    in f64 (the C version stores f32 with f64 products; offline augmentation
    tolerates the tiny difference)."""
    from scipy.signal import lfilter
    return lfilter([1.0, b[0], b[1]], [1.0, a[0], a[1]],
                   x.astype(np.float64)).astype(np.float32)


def _rand_excerpt(rng, data: np.ndarray, n: int) -> np.ndarray:
    pos = int(rng.random() * max(1, data.shape[0]))
    pos = min(pos, max(0, data.shape[0] - n))
    ex = data[pos:pos + n]
    if ex.shape[0] < n:
        ex = np.pad(ex, (0, n - ex.shape[0]))
    return ex.astype(np.float32)


def generate_sequence(rng, speech16, noise16, fgnoise16,
                      rirs: RIRList | None, seq_len: int = SEQUENCE_LENGTH):
    """One augmented (clean, noisy, vad, band_lp, lowpass, noise_free) tuple
    (dump_features.c:351-465)."""
    n_samples = seq_len * FRAME_SIZE
    x = _rand_excerpt(rng, speech16, n_samples)
    n = _rand_excerpt(rng, noise16, n_samples)
    fn = _rand_excerpt(rng, fgnoise16, n_samples)

    start_pos = 0
    if rng.integers(4) == 0:
        start_pos = int(-1000 * np.log(rng.random() + 1e-12))
    start_pos = min(start_pos, n_samples)

    speech_gain = 10.0 ** ((-45 + 45 * rng.random() + 10 * rng.random()) / 20)
    noise_gain = 10.0 ** ((-30 + 40 * rng.random() + 15 * rng.random()) / 20)
    fgnoise_gain = 10.0 ** ((-30 + 40 * rng.random() + 15 * rng.random()) / 20)
    if rng.integers(8) == 0:
        noise_gain = 0.0
    if rng.integers(8) != 0:
        fgnoise_gain = 0.0
    if rng.integers(12) == 0:
        noise_gain *= 0.03
        fgnoise_gain *= 0.03
    noise_gain *= speech_gain
    fgnoise_gain *= speech_gain

    a_noise, b_noise = rand_resp(rng)
    a_fg, b_fg = rand_resp(rng)
    a_sig, b_sig = rand_resp(rng)
    lowpass = int(FREQ_SIZE * 3000.0 / 24000.0 * (50.0 ** rng.random()))

    E = np.sum((x.reshape(seq_len, FRAME_SIZE) ** 2), axis=1)
    vad = viterbi_vad(E)

    x = _biquad_f64(x, BIQUAD_HP_B, BIQUAD_HP_A)
    x = _biquad_f64(x, b_sig, a_sig)
    n = _biquad_f64(n, BIQUAD_HP_B, BIQUAD_HP_A)
    n = _biquad_f64(n, b_noise, a_noise)
    fn = _biquad_f64(fn, BIQUAD_HP_B, BIQUAD_HP_A)
    fn = _biquad_f64(fn, b_fg, a_fg)

    speech_rms = weighted_rms_fast(x)
    noise_rms = weighted_rms_fast(n)
    fgnoise_rms = weighted_rms_fast(fn)

    vad[: start_pos // FRAME_SIZE] = 0
    x = clear_vad(x, vad)

    x *= speech_gain * 3000.0 / (1 + speech_rms)
    n *= noise_gain * 3000.0 / (1 + noise_rms)
    fn *= fgnoise_gain * 3000.0 / (1 + fgnoise_rms)
    xn = x + n + fn

    if rirs is not None and rng.integers(2) == 0:
        rid = int(rng.integers(rirs.rir.shape[0]))
        x = rir_filter_sequence(x, rirs.early[rid])
        xn = rir_filter_sequence(xn, rirs.rir[rid])
    if rng.integers(4) == 0:
        xn = np.clip(xn, -32767.0, 32767.0)      # input clipping, not target
    if rng.integers(2) == 0:
        xn = np.floor(0.5 + xn)                  # 16-bit requantisation

    noise_free = (noise_gain == 0.0) and (fgnoise_gain == 0.0)
    return x, xn, vad, lowpass, noise_free


def dump_features(speech_path, noise_path, fg_path, out_path, count,
                  rir_list=None, batch=16, seed=None,
                  seq_len=SEQUENCE_LENGTH, device="cuda"):
    device = resolve_device(device)
    speech16 = np.memmap(speech_path, dtype=np.int16, mode="r")
    noise16 = np.memmap(noise_path, dtype=np.int16, mode="r")
    fg16 = np.memmap(fg_path, dtype=np.int16, mode="r")
    rirs = load_rir_list(rir_list) if rir_list else None
    rng = np.random.default_rng(seed)

    with open(out_path, "wb") as fout:
        done = 0
        while done < count:
            B = min(batch, count - done)
            seqs = [generate_sequence(rng, speech16, noise16, fg16, rirs,
                                      seq_len)
                    for _ in range(B)]
            clean = np.stack([s[0] for s in seqs])
            noisy = np.stack([s[1] for s in seqs])
            vad = np.stack([s[2] for s in seqs])
            lowpass = np.array([s[3] for s in seqs], np.int32)
            noise_free = np.array([s[4] for s in seqs])
            band_lp = band_lp_from_lowpass(lowpass)

            Ey, Ex, feats, silence = (
                a.cpu().numpy() for a in _sequence_features(
                    *(torch.from_numpy(a).to(device)
                      for a in (clean, noisy, lowpass))))

            g = compute_targets(Ey, Ex, silence, vad, band_lp, noise_free)
            rec = np.concatenate(
                [feats, g, vad[:, :, None].astype(np.float32)], axis=-1)
            rec.astype(np.float32).tofile(fout)
            done += B
            print(f"{done}/{count}", file=sys.stderr, end="\r", flush=True)
    print(file=sys.stderr)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-rir_list", default=None)
    p.add_argument("speech")
    p.add_argument("noise")
    p.add_argument("fg_noise")
    p.add_argument("output")
    p.add_argument("count", type=int)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sequence-length", type=int, default=SEQUENCE_LENGTH)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    dump_features(a.speech, a.noise, a.fg_noise, a.output, a.count,
                  rir_list=a.rir_list, batch=a.batch, seed=a.seed,
                  seq_len=a.sequence_length, device=a.device)


if __name__ == "__main__":
    main()

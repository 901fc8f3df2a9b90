"""Precomputed constant tables (numpy), built as matrices so the per-bin scalar
loops of the reference become batched matmuls.  A copy of
``rnnoise_tpu/tables.py``, kept here so the port never imports the JAX package.

Reference provenance:
  * ``eband20ms``      – reference src/denoise.c:63-65
  * band energy/corr   – reference src/denoise.c:90-138 (triangular weights)
  * interp_band_gain   – reference src/denoise.c:140-154 (incl. the 20 kHz
                         brick-wall: bins 401..480 are never written and all
                         callers zero-initialise them)
  * Vorbis half window – reference src/dump_rnnoise_tables.c:84-89
  * DCT-II table       – reference src/dump_rnnoise_tables.c:91-101 and the
                         legacy ``sqrt(2/22)`` scale at src/denoise.c:160-170
"""

from __future__ import annotations

import functools

import numpy as np

from .config import FRAME_SIZE, FREQ_SIZE, NB_BANDS

# Band edges in 50 Hz FFT-bin units; 32 bands plus 2 guard edges.
EBAND20MS = np.array(
    [0, 2, 4, 6, 8, 10, 12, 15, 18, 21, 24, 28, 32, 36, 41, 47, 53, 60, 68,
     77, 87, 98, 110, 124, 140, 157, 176, 198, 223, 251, 282, 317, 356, 400],
    dtype=np.int32,
)


@functools.lru_cache(maxsize=None)
def band_matrix() -> np.ndarray:
    """[NB_BANDS, FREQ_SIZE] matrix E with bandE = E @ per_bin_energy.

    Encodes the triangular accumulation of src/denoise.c:90-113 including the
    edge-band ``*2/3`` folding (denoise.c:107-108).
    """
    B = np.zeros((NB_BANDS + 2, FREQ_SIZE), dtype=np.float64)
    for i in range(NB_BANDS + 1):
        lo, hi = EBAND20MS[i], EBAND20MS[i + 1]
        size = hi - lo
        for j in range(size):
            frac = j / size
            B[i, lo + j] += 1.0 - frac
            B[i + 1, lo + j] += frac
    out = np.zeros((NB_BANDS, FREQ_SIZE), dtype=np.float64)
    out[0] = (B[0] + B[1]) * (2.0 / 3.0)
    out[1:NB_BANDS - 1] = B[2:NB_BANDS]
    out[NB_BANDS - 1] = (B[NB_BANDS] + B[NB_BANDS + 1]) * (2.0 / 3.0)
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def interp_matrix() -> np.ndarray:
    """[FREQ_SIZE, NB_BANDS] matrix G with per_bin_gain = G @ band_gain.

    Follows src/denoise.c:140-154: bins below eband[1] clamp to band 0, bins in
    [eband[32], eband[33]) clamp to band 31, and bins 401..480 stay zero (the
    callers' zero-init makes this a 20 kHz brick wall).
    """
    G = np.zeros((FREQ_SIZE, NB_BANDS), dtype=np.float64)
    for i in range(1, NB_BANDS):
        lo, hi = EBAND20MS[i], EBAND20MS[i + 1]
        size = hi - lo
        for j in range(size):
            frac = j / size
            G[lo + j, i - 1] = 1.0 - frac
            G[lo + j, i] = frac
    G[: EBAND20MS[1], 0] = 1.0
    G[EBAND20MS[NB_BANDS]: EBAND20MS[NB_BANDS + 1], NB_BANDS - 1] = 1.0
    return G.astype(np.float32)


@functools.lru_cache(maxsize=None)
def half_window() -> np.ndarray:
    """Vorbis power-complementary half window, length FRAME_SIZE."""
    i = np.arange(FRAME_SIZE, dtype=np.float64)
    s = np.sin(0.5 * np.pi * (i + 0.5) / FRAME_SIZE)
    return np.sin(0.5 * np.pi * s * s).astype(np.float32)


@functools.lru_cache(maxsize=None)
def full_window() -> np.ndarray:
    """Symmetric full analysis/synthesis window, length WINDOW_SIZE
    (src/denoise.c:219-225 applies half_window to both halves)."""
    h = half_window()
    return np.concatenate([h, h[::-1]]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_matrix() -> np.ndarray:
    """[NB_BANDS, NB_BANDS] matrix D with dct(x) = D @ x.

    C computes out[i] = sqrt(2/22) * sum_j in[j] * cos((j+.5)*i*pi/32), with the
    i == 0 row additionally scaled by sqrt(.5)  (src/denoise.c:160-170,
    src/dump_rnnoise_tables.c:91-101 — note the legacy 22-band scale).
    """
    i = np.arange(NB_BANDS, dtype=np.float64)[:, None]   # output index
    j = np.arange(NB_BANDS, dtype=np.float64)[None, :]   # input index
    D = np.cos((j + 0.5) * i * np.pi / NB_BANDS)
    D[0, :] *= np.sqrt(0.5)
    D *= np.sqrt(2.0 / 22.0)
    return D.astype(np.float32)


# High-pass biquad used on the input PCM (src/denoise.c:469-470).
BIQUAD_HP_B = np.array([-2.0, 1.0], dtype=np.float32)
BIQUAD_HP_A = np.array([-1.99599, 0.99600], dtype=np.float32)

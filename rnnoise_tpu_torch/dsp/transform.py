"""Windowing, the 960-point real DFT, band energies and the band-gain
interpolation, batched over a leading stream axis — the counterpart of
``rnnoise_tpu/dsp/transform.py``.

Spectra are stored as real ``[..., 962]`` tensors, re|im halves in natural
bin order (the layout the JAX package uses on CPU).  Scaling follows the
reference's KissFFT: forward = DFT / 960 (src/kiss_fft.c:459,582), inverse
= unscaled inverse DFT of the conjugate-symmetric spectrum (denoise.c:
200-217).  The transforms are dense DFT matmuls, which the spectral
kernels of ``cuda_spectral.py`` replace on the main path.  The forward ones
sum in f64 and round once to f32: the spectra feed the pitch, band-energy
and silence decisions, where an f32 sum's ~1e-6 error flips an int8
activation now and then.  The inverse only shapes the output and sums in
f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..config import FRAME_SIZE, FREQ_SIZE, WINDOW_SIZE


@functools.lru_cache(maxsize=None)
def _dft_matrices(windowed: bool):
    """(fwd [960, 962], inv [962, 960]) in f64; with the Vorbis window
    folded into the rows (forward) or columns (inverse) when ``windowed``."""
    n = np.arange(WINDOW_SIZE)[:, None]
    k = np.arange(FREQ_SIZE)[None, :]
    ang = -2.0 * np.pi * n * k / WINDOW_SIZE
    fwd = np.concatenate([np.cos(ang), np.sin(ang)], axis=1) / WINDOW_SIZE
    # x[n] = sum_k w_k (re_k cos(2 pi k n / N) - im_k sin(2 pi k n / N)),
    # w_k = 1 for k in {0, N/2}, else 2.
    w = np.full(FREQ_SIZE, 2.0)
    w[0] = w[FREQ_SIZE - 1] = 1.0
    ang_i = -ang.T                                       # [FREQ, WINDOW]
    inv = np.concatenate([w[:, None] * np.cos(ang_i),
                          -w[:, None] * np.sin(ang_i)], axis=0)
    if windowed:
        win = tables.full_window().astype(np.float64)
        fwd, inv = win[:, None] * fwd, inv * win[None, :]
    return fwd, inv


@functools.lru_cache(maxsize=None)
def _device_matrix(name: str, windowed: bool, device: str) -> torch.Tensor:
    """The forward matrix in f64, the inverse in f32."""
    fwd, inv = _dft_matrices(windowed)
    m = fwd if name == "fwd" else inv.astype(np.float32)
    return torch.from_numpy(m).to(device)


@functools.lru_cache(maxsize=None)
def _device_table(name: str, device: str) -> torch.Tensor:
    m = {"band": lambda: tables.band_matrix().T,
         "interp": lambda: tables.interp_matrix().T,
         "dct": lambda: tables.dct_matrix().T,
         "window": tables.full_window}[name]()
    return torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(device)


def forward_transform(x: torch.Tensor) -> torch.Tensor:
    """x: [..., 960] real -> [..., 962] re|im, scaled 1/960."""
    return (x.float().double()
            @ _device_matrix("fwd", False, str(x.device))).float()


def inverse_transform(Y: torch.Tensor) -> torch.Tensor:
    """Y: [..., 962] re|im -> [..., 960] real, unscaled."""
    return Y @ _device_matrix("inv", False, str(Y.device))


def windowed_forward_transform(x: torch.Tensor) -> torch.Tensor:
    """forward_transform(window * x) in one matmul."""
    return (x.float().double()
            @ _device_matrix("fwd", True, str(x.device))).float()


def windowed_inverse_transform(Y: torch.Tensor) -> torch.Tensor:
    """window * inverse_transform(Y) in one matmul."""
    return Y @ _device_matrix("inv", True, str(Y.device))


def apply_window(x: torch.Tensor) -> torch.Tensor:
    """x: [..., 960] -> windowed [..., 960]."""
    return x * _device_table("window", str(x.device))


def compute_band_energy(X: torch.Tensor) -> torch.Tensor:
    """X: [..., 962] re|im -> [..., 32] triangular band energies
    (src/denoise.c:90-113)."""
    re, im = X[..., :FREQ_SIZE], X[..., FREQ_SIZE:]
    return (re * re + im * im) @ _device_table("band", str(X.device))


def compute_band_corr(X: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Triangular-banded Re{X conj(P)} (src/denoise.c:115-138)."""
    c = X[..., :FREQ_SIZE] * P[..., :FREQ_SIZE] \
        + X[..., FREQ_SIZE:] * P[..., FREQ_SIZE:]
    return c @ _device_table("band", str(X.device))


def interp_band_gain(band_g: torch.Tensor) -> torch.Tensor:
    """band_g: [..., 32] -> per-bin gain [..., 481]; bins 401..480 come out
    zero (the 20 kHz brick wall, src/denoise.c:140-154)."""
    return band_g @ _device_table("interp", str(band_g.device))


def dct(x: torch.Tensor) -> torch.Tensor:
    """32-point DCT-II with the reference's legacy sqrt(2/22) scaling."""
    return x @ _device_table("dct", str(x.device))


def frame_synthesis(synthesis_mem: torch.Tensor, Y: torch.Tensor,
                    plain: bool = False):
    """Inverse transform + window + overlap-add (src/denoise.c:400-407).

    synthesis_mem: [S, 480]; Y: [S, 962] re|im.  The inverse runs through
    the inverse-spectrum kernel wrapper (its plain version when ``plain``).
    Returns (new_synthesis_mem, out_pcm[S, 480])."""
    from . import cuda_spectral
    inverse = (cuda_spectral.inverse_spectral_plain if plain
               else cuda_spectral.inverse_spectral)
    x = inverse(Y)
    return x[:, FRAME_SIZE:], x[:, :FRAME_SIZE] + synthesis_mem

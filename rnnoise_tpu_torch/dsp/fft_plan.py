"""The plan of the forward spectra's f64 FFT (``csrc/spectral_common.cuh``).

Each windowed real input v of N = 960 samples is transformed as one complex
sequence of H = 480 points, c[m] = w[2m] v[2m] + i w[2m+1] v[2m+1].  Its
f64 FFT C gives the spectrum in one last pass,

    V[k] = (C[k] + conj C[-k]) / 2 - i tw(k) (C[k] - conj C[-k]) / 2,

for k <= 480 (indices of C mod 480), scaled by 1/960 and rounded once to
f32.  A stream's two inputs (X's [mem | x] and P's pitch window) are two
such sequences, never mixed, so each spectrum's error is relative to its
own input: a silent input gives an exactly zero spectrum.

The FFT is a mixed-radix Stockham transform (decimation in time, outputs in
natural order), one stage per radix of :data:`FFT_RADICES`; the kernel reads
the first stage's inputs from device memory and runs the other two in
place in shared memory.  Stage s with radix R follows Ns = R_0 ... R_{s-1}
(1 at the first stage) and computes, for each butterfly j < H / R, with
jm = j mod Ns:

    v[r]  = in[j + r H / R] * tw(2 jm r H / (Ns R)),   r < R
    v'[q] = sum_r v[r] tw(2 r q H / R)                  (a DFT-R)
    out[(j - jm) R + jm + q Ns] = v'[q]

where tw(m) = exp(-2 pi i m / 960).  Every twiddle is a power of the 960th
root of unity, taken from the exact table of ``kernel_tables`` (cos, sin of
2 pi m / 960, exact at the quarter turns).  The first stage (Ns = 1) is a
radix-2 butterfly without twiddles; the radix-16 butterfly runs as 4 x 4
with the roots of 16 as its inner twiddles, the radix-15 one by the
prime-factor map 3 x 5, both from a table of their R roots.

The inverse spectrum (``inv_spectra``) runs the same stages on one
sequence per spectrum.  The unscaled inverse x of a conjugate-symmetric
spectrum X (bins k <= 480, bins 0 and 480 taken real) is, as the complex
sequence z[m] = x[2m] + i x[2m+1], the unscaled inverse FFT of

    Z[k] = (X[k] + conj X[480-k]) + i conj(tw(k)) (X[k] - conj X[480-k]),

k < 480, the mirror of the forward's last pass.  A first pass forms conj Z
and the forward FFT of it is conj z, so x[2m] = Re FFT(conj Z)[m] and
x[2m+1] = -Im FFT(conj Z)[m]; each sample is windowed in f64 and rounded
once to f32.

The kernel reads the twiddles from the table this module builds
(:func:`fft_table`), which the wrappers append to the 960 base twiddles:
for each stage s >= 1, its (R - 1) x Ns twiddles (row r - 1, column jm),
then its R roots.  The kernel computes the same offsets from the same
radices (``FFT_R0`` .. ``FFT_R2`` in ``spectral_common.cuh``);
tests/test_torch_fft_plan.py holds the two against each other and emulates
the stages in numpy.
"""

from __future__ import annotations

import numpy as np

N = 960
H = N // 2
FFT_RADICES = (2, 16, 15)
# f64 operations of one butterfly of each radix as the kernel computes it:
# radix 2 as 4 adds; radix 16 as 4 x 4 (8 radix-4 butterflies of 16 adds
# and 9 twiddles of 4); radix 15 by the prime-factor map (5 DFT-3s of 14
# and 3 DFT-5s of 36, in the symmetric form)
BUTTERFLY_OPS = {2: 4, 16: 8 * 16 + 9 * 4, 15: 5 * 14 + 3 * 36}


def stages():
    """[(R, Ns, offset)] per stage: the radix, the product of the radices
    before it, and the offset of its twiddles in :func:`fft_table` (None
    for the first stage, which has none)."""
    out, ns, off = [], 1, 0
    for s, R in enumerate(FFT_RADICES):
        if s == 0:
            out.append((R, ns, None))
        else:
            out.append((R, ns, off))
            off += (R - 1) * ns + R
        ns *= R
    assert ns == H
    return out


def stage_maps(R: int, ns: int):
    """The address arithmetic of one stage: (inp [H/R, R] input index,
    out [H/R, R] output index, tw [H/R, R] exponent m of the twiddle tw(m)
    applied to v[r])."""
    M = H // R
    j = np.arange(M)[:, None]
    r = np.arange(R)[None, :]
    jm = j % ns
    inp = j + r * M
    out = (j - jm) * R + jm + r * ns
    tw = (2 * jm * r * (H // (ns * R))) % N
    return inp, out, tw


def forward_root(base_tw: np.ndarray, m) -> np.ndarray:
    """exp(-2 pi i m / 960) from the base table (cos, sin of 2 pi m / 960):
    [..., 2] as (re, im)."""
    t = base_tw[np.asarray(m) % N]
    return np.stack([t[..., 0], -t[..., 1]], axis=-1)


def fft_table(base_tw: np.ndarray) -> np.ndarray:
    """The FFT's twiddles [509, 2] f64 (re, im), in the kernel's layout (see
    the module docstring), from the base table [960, 2]."""
    parts = []
    for R, ns, _ in stages()[1:]:
        m = stage_maps(R, ns)[2][:ns, 1:].T            # [r - 1, jm]
        parts.append(forward_root(base_tw, m).reshape(-1, 2))
        parts.append(forward_root(base_tw, 2 * np.arange(R) * (H // R)))
    return np.concatenate(parts, axis=0)


def _sequence_ops() -> int:
    """f64 operations of the stages on one sequence: the butterflies
    (BUTTERFLY_OPS) with 4 per complex twiddle."""
    return sum((H // R) * (BUTTERFLY_OPS[R] + (4 * (R - 1) if ns > 1 else 0))
               for R, ns, _ in stages())


def f64_ops_per_stream() -> int:
    """f64 operations (add, multiply or fused multiply-add, one each) of the
    kernel's two forward spectra of one stream: the windowing products, for
    each of the two sequences the stages (_sequence_ops) and the last pass
    over its 481 bins (6 adds, a complex multiply of 4 and 2 scalings)."""
    return 2 * N + 2 * (_sequence_ops() + 12 * (H + 1))


def inverse_f64_ops_per_stream() -> int:
    """f64 operations of the inverse of one spectrum as the kernel computes
    it: the first pass over the 480 points of conj Z (4 adds, a complex
    multiply of 4 and a complex add of 2), the stages on one sequence
    (_sequence_ops) and the window's 960 products."""
    return 10 * H + _sequence_ops() + N

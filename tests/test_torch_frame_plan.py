"""The plans of the redesigned post-filter and whole-chunk kernels, on CPU.

The post-filter (``csrc/postfilter_body.cuh``) and the whole-chunk kernel
(``csrc/frame.cu``) run only on the card.  What they take from the host is
checked here: the compact band tables (each bin touches two neighbouring
bands) against the dense tables of both packages, the 2-term interpolation
against the 32-term f32 dot product it replaces, bit for bit, in a numpy
emulation of the f32 fused multiply-add; and the tiling of the HP biquad's
Toeplitz term, its cover of the triangle and a numpy f64 emulation of its
sums against the plain ``biquad_frames``.  The constants written both in
CUDA and in Python are held in step.
"""

import os
import re

import numpy as np
import pytest
import torch

from rnnoise_tpu import tables as jtab
from rnnoise_tpu_torch import kernels, tables
from rnnoise_tpu_torch.config import FRAME_SIZE, FREQ_SIZE, NB_BANDS
from rnnoise_tpu_torch.dsp import biquad, cuda_frame
from rnnoise_tpu_torch.dsp import cuda_spectral as spec
from tests.conftest import speechlike
from tests.torch_helpers import no_jax_compile_cache  # noqa: F401


def _source(name):
    with open(os.path.join(kernels.CSRC_DIR, name)) as f:
        return f.read()


def _dense():
    """{pairs row: the dense bin -> band table [481, 32] it encodes}."""
    return {spec.PAIR_INTERP: tables.interp_matrix(),
            spec.PAIR_BAND: tables.band_matrix().T}


def fmaf(a, b, c):
    """f32 fused multiply-add, rounded once.  a b is exact in f64; the f64
    sum s = a b + c keeps its rounding error e (two-sum), and s rounds to
    f32 as the exact sum does unless s lies halfway between two floats,
    where the sign of e decides."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    e = (p - bp) + (c - (s - bp))
    r = s.astype(np.float32)
    for toward, sign in ((np.inf, 1.0), (-np.inf, -1.0)):
        nb = np.nextafter(r, np.float32(toward))
        half = (r.astype(np.float64) + nb.astype(np.float64)) / 2
        r = np.where((s == half) & (sign * e > 0), nb, r)
    return r


def band_dot(m, v):
    """postfilter_body.cuh's former interpolation: the 32 terms m[b] v[b]
    in band order, f32 FMA, from +0."""
    acc = np.float32(0.0)
    for b in range(m.shape[-1]):
        acc = fmaf(m[..., b], v[..., b], acc)
    return acc


def pair_interp(p, v):
    """postfilter_body.cuh:pair_interp for every bin: two FMAs in band order."""
    b = p[:, 2].astype(np.int64)
    take = np.take_along_axis
    vb = take(v[:, None, :], b[None, :, None], 2)[..., 0]
    vb1 = take(v[:, None, :], b[None, :, None] + 1, 2)[..., 0]
    return fmaf(p[:, 1], vb1, fmaf(p[:, 0], vb, np.float32(0.0)))


def test_fmaf_emulation_rounds_once():
    """The emulation against cases that a product rounded first gets wrong,
    and an exact product-plus-sum in rational arithmetic."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a = (rng.standard_normal(2000) * 10 ** rng.uniform(-4, 4, 2000)).astype(np.float32)
    b = (rng.standard_normal(2000) * 10 ** rng.uniform(-4, 4, 2000)).astype(np.float32)
    c = (-a.astype(np.float64) * b.astype(np.float64)
         * (1 + 1e-7 * rng.standard_normal(2000))).astype(np.float32)
    got = fmaf(a, b, c)
    for i in range(0, 2000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                         int(np.float32(x).view(np.int32)) & 1))
        assert got[i] == best, i
    assert (got != (a * b + c)).any()          # two roundings differ somewhere


@pytest.mark.parametrize("which", ["interp", "band"])
def test_band_pairs_reproduce_the_dense_tables(which):
    """Each bin's pair (w0, w1, b) holds the dense row exactly (bands b and
    b + 1, zeros elsewhere), derived from the nonzeros; the dense tables
    are the JAX package's."""
    row = spec.PAIR_INTERP if which == "interp" else spec.PAIR_BAND
    m = _dense()[row]
    ref = jtab.interp_matrix() if which == "interp" else jtab.band_matrix().T
    assert np.array_equal(m, np.asarray(ref))
    pairs = spec.band_tables("cpu")[0].numpy()[row]
    assert pairs.shape == (FREQ_SIZE, 4)
    back = np.zeros_like(m)
    for k, (w0, w1, b, z) in enumerate(pairs):
        assert z == 0.0 and b == int(b) and 0 <= b <= NB_BANDS - 2
        back[k, int(b)] += w0
        back[k, int(b) + 1] += w1
    assert np.array_equal(back, m)
    assert int((m != 0).sum()) == 723         # ~5 % of 481 x 32


def test_band_ranges_hold_each_band_sum():
    """Band b's energy over its range, each bin weighted by pair_weight
    (w0 if the bin's first band is b, else w1), is the dense column, and
    the ranges are the columns' nonzero bins."""
    pairs, ranges = (t.numpy() for t in spec.band_tables("cpu"))
    band = _dense()[spec.PAIR_BAND]
    for b, (lo, hi) in enumerate(ranges):
        nz = np.flatnonzero(band[:, b])
        assert (lo, hi) == (nz[0], nz[-1] + 1)
        col = np.zeros(FREQ_SIZE, np.float32)
        for k in range(lo, hi):
            p = pairs[spec.PAIR_BAND, k]
            assert int(p[2]) in (b, b - 1)
            col[k] = p[0] if int(p[2]) == b else p[1]
        assert np.array_equal(col, band[:, b])


def test_band_energy_over_ranges_matches_plain():
    """The f64 sum over a band's own bins in ascending order, rounded once,
    against transform.compute_band_energy (an f64 table product rounded
    once): the same floats but for an ulp in rare ties."""
    from rnnoise_tpu_torch.dsp import transform
    rng = np.random.default_rng(11)
    X = (300 * rng.standard_normal((16, 2 * FREQ_SIZE))).astype(np.float32)
    X[3] *= 1e-4
    pairs, ranges = (t.numpy() for t in spec.band_tables("cpu"))
    e2 = (X[:, :FREQ_SIZE] * X[:, :FREQ_SIZE] + X[:, FREQ_SIZE:] * X[:, FREQ_SIZE:])
    got = np.zeros((16, NB_BANDS), np.float32)
    for b, (lo, hi) in enumerate(ranges):
        acc = np.zeros(16)
        for k in range(lo, hi):
            p = pairs[spec.PAIR_BAND, k]
            acc = acc + float(p[0] if int(p[2]) == b else p[1]) * e2[:, k].astype(np.float64)
        got[:, b] = acc.astype(np.float32)
    ref = transform.compute_band_energy(torch.from_numpy(X)).numpy()
    d = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    assert int(d.max()) <= 1 and (d == 0).mean() > 0.99


@pytest.mark.parametrize("kind", ["signed", "gains"])
def test_pair_interp_equals_the_32_term_dot_bit_for_bit(kind):
    """pair_interp's two FMAs give the float that the 32-term band_dot gave,
    for every bin, on random finite band values (signed over 8 decades, or
    non-negative as r, norm and gc are): its other terms add exactly 0 to a
    sum that starts at +0."""
    rng = np.random.default_rng(7 if kind == "signed" else 8)
    n = 64
    v = rng.standard_normal((n, NB_BANDS)) * 10 ** rng.uniform(-4, 4, (n, NB_BANDS))
    if kind == "gains":
        v = np.abs(v)
        v[0] = 0.0
    v = v.astype(np.float32)
    interp = _dense()[spec.PAIR_INTERP]
    pairs = spec.band_tables("cpu")[0].numpy()[spec.PAIR_INTERP]
    dense = band_dot(interp[None], v[:, None, :])
    two = pair_interp(pairs, v)
    assert dense.shape == two.shape == (n, FREQ_SIZE)
    assert np.array_equal(dense.view(np.uint32), two.view(np.uint32))
    assert not two[:, 401:].any()                     # the 20 kHz brick wall


def test_band_pairs_reject_other_shapes():
    m = np.zeros((5, 4), np.float32)
    m[1, [0, 2]] = 1.0
    with pytest.raises(ValueError):
        spec.band_pairs(m)
    m = np.zeros((5, 4), np.float32)
    m[[0, 2], 1] = 1.0
    with pytest.raises(ValueError):
        spec.band_ranges(m)


def test_biquad_tiles_cover_the_triangle_once():
    """Every (output i, tap d < i) is summed by exactly one thread's tile,
    the padded steps (d >= i) read only the XPAD zeros before the frame,
    and every thread runs the same number of steps."""
    tile = cuda_frame.HP_TILE
    seen = np.zeros((FRAME_SIZE, FRAME_SIZE), np.int64)
    steps = set()
    pads = []
    for tiles in cuda_frame.biquad_tiles():
        n = 0
        for i0 in tiles:
            for d in range(i0 + tile - 1):
                n += 1
                for r in range(tile):
                    i = i0 + r
                    if d < i:
                        seen[i, d] += 1
                    else:
                        pads.append(i - 1 - d)
        steps.add(n)
    i, d = np.indices(seen.shape)
    assert (seen[d < i] == 1).all() and (seen[d >= i] == 0).all()
    assert min(pads) >= -tile and max(pads) <= -1
    assert len(steps) == 1 and len(cuda_frame.biquad_tiles()) == FRAME_SIZE // tile // 2


def _tiled_biquad(x, mem, K, rowA, SA, SB):
    """frame.cu's biquad for one frame of S streams in numpy f64 (without
    the kernel's FMA): each output's taps in the tiles' order, rounded once;
    the state sum as a warp adds it (lanes i mod 32 in order, then the
    shuffle tree)."""
    S, N = x.shape
    k = K[1:, 0]                                        # k_0 .. k_478
    xp = np.concatenate([np.zeros((S, cuda_frame.HP_TILE)), x.astype(np.float64)], 1)
    acc = np.zeros((S, N))
    for tiles in cuda_frame.biquad_tiles(N):
        for i0 in tiles:
            for d in range(i0 + cuda_frame.HP_TILE - 1):
                for r in range(cuda_frame.HP_TILE):
                    acc[:, i0 + r] += k[d] * xp[:, cuda_frame.HP_TILE + i0 + r - 1 - d]
    m = mem.astype(np.float64)
    st = m[:, 1:] * rowA[None, :, 1] + m[:, :1] * rowA[None, :, 0]
    y = (x + acc.astype(np.float32)) + st.astype(np.float32)
    new = np.empty((S, 2), np.float32)
    for j in range(2):
        lanes = np.stack([(x[:, l::32].astype(np.float64) * SB[l::32, j]).cumsum(1)[:, -1]
                          for l in range(32)], 1)
        for off in (16, 8, 4, 2, 1):
            lanes[:, :off] = lanes[:, :off] + lanes[:, off:2 * off]
        new[:, j] = (m[:, 1] * SA[j, 1] + m[:, 0] * SA[j, 0] + lanes[:, 0]).astype(np.float32)
    return y.astype(np.float32), new


def test_tiled_biquad_emulation_matches_biquad_frames():
    """The tiled sums, rounded once, against biquad_frames' "f64" rounding
    (the same products summed by an f64 matmul) on speech-like int16 frames
    with a near-silent one, each frame from the plain version's state: every
    output and state value within 1 f32 ulp, nearly all equal."""
    rng = np.random.default_rng(21)
    S, T = 3, 4
    x = np.stack([np.round(speechlike(rng, T * FRAME_SIZE, f0=100.0 + 40 * s))
                  for s in range(S)]).reshape(S, T, FRAME_SIZE).transpose(1, 0, 2)
    x[2, 1] = np.round(x[2, 1] * 1e-3)
    x = x.astype(np.float32)
    bq = tuple(float(v) for v in tables.BIQUAD_HP_B), tuple(float(v) for v in tables.BIQUAD_HP_A)
    K, rowA, SA, SB = biquad._biquad_kernels(*bq, FRAME_SIZE)
    mem = np.zeros((S, 2), np.float32)
    same = total = 0
    for t in range(T):
        y_ref, mem_ref = biquad.biquad_frames(torch.from_numpy(x[t:t + 1]),
                                              torch.from_numpy(mem), tables.BIQUAD_HP_B,
                                              tables.BIQUAD_HP_A, "f64")
        y, new = _tiled_biquad(x[t], mem, K, rowA, SA, SB)
        for got, ref in ((y, y_ref[0].numpy()), (new, mem_ref.numpy())):
            d = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
            assert int(d.max()) <= 1
            same += int((d == 0).sum())
            total += d.size
        mem = mem_ref.numpy()
    assert same / total > 0.99


def test_constants_match_kernel_sources():
    """The constants written both in CUDA and in Python: the biquad's tile,
    the compact tables' row order and width."""
    frame = _source("frame.cu")
    assert int(re.search(r"constexpr int HP_TILE = (\d+);", frame).group(1)) == cuda_frame.HP_TILE
    post = _source("postfilter_body.cuh")
    got = re.search(r"constexpr int PAIR_INTERP = (\d+), PAIR_BAND = (\d+);", post)
    assert (int(got.group(1)), int(got.group(2))) == (spec.PAIR_INTERP, spec.PAIR_BAND)
    assert spec.band_tables("cpu")[0].shape[-1] * 4 == 16            # one float4 a bin
    assert "float4 pairs[2 * NBIN];" in frame and "const float4* __restrict__ pairs" in post

"""The plans of the redesigned spectrum and lag-table kernels, on CPU.

The forward and inverse spectra's FFT (``csrc/spectral_common.cuh``) and the
lag table's tiles (``csrc/analysis_body.cuh``: ``lag_partials``, the table
alone; the analysis' tensor-core tiles are ``tests/test_torch_lag_plan.py``'s)
run only on the card.  Their
plans live in Python (``dsp/fft_plan.py``, ``dsp/cuda_xcorr.py``) and the
wrappers hand the FFT's twiddle table to the kernels; here numpy emulates
the kernels' stage sequence and tile sums with exactly those tables and that
order, and holds them against the plain versions and the JAX package.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu.dsp import pallas_spectral as jps
from rnnoise_tpu.dsp import transform as jtr
from rnnoise_tpu.dsp.gather import take_window as jtake
from rnnoise_tpu_torch import kernels
from rnnoise_tpu_torch.dsp import cuda_spectral as spec
from rnnoise_tpu_torch.dsp import cuda_xcorr, fft_plan, pitch
from rnnoise_tpu_torch.dsp import transform as ttr
from tests.torch_helpers import no_jax_compile_cache  # noqa: F401

N = 960


def _source(name):
    with open(os.path.join(kernels.CSRC_DIR, name)) as f:
        return f.read()


def _rel(a, b):
    return float((np.abs(a - b).max(1) / np.abs(b).max(1)).max())


def _ulps(a, b):
    """|a - b| in f32 ulps, elementwise."""
    def key(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def emulate_fft(c, table):
    """The kernel's stages on complex c [S, 480], with the twiddles and
    roots read from ``table`` (fft_tables' rows after the first 960) at the
    kernel's offsets."""
    t = table[:, 0] + 1j * table[:, 1]
    a = c
    for R, ns, off in fft_plan.stages():
        inp, out, _ = fft_plan.stage_maps(R, ns)
        v = a[:, inp]                                    # [S, 480/R, R]
        if off is None:
            W = np.array([1.0, -1.0])
        else:
            jm = np.arange(fft_plan.H // R)[:, None] % ns
            r = np.arange(1, R)[None, :]
            v[:, :, 1:] = v[:, :, 1:] * t[off + (r - 1) * ns + jm]
            W = t[off + (R - 1) * ns + np.arange(R)]
        q = np.arange(R)
        v = v @ W[(q[:, None] * q[None, :]) % R]         # sum_r v[r] W[r q]
        b = np.empty_like(a)
        b[:, out] = v
        a = b
    return a


def emulate_spectrum(v):
    """The kernel's spectrum [S, 962] f64 (not rounded) of real inputs
    v [S, 960]: the windowed even and odd samples as one complex sequence,
    its FFT, and the last pass with the base twiddles."""
    win = spec.kernel_tables("cpu")[0].numpy().astype(np.float64)
    u = win * v.astype(np.float64)
    C = emulate_fft(u[:, 0::2] + 1j * u[:, 1::2], spec.fft_tables("cpu").numpy()[N:])
    k = np.arange(N // 2 + 1)
    a, b = C[:, k % 480], np.conj(C[:, (480 - k) % 480])
    base = spec.kernel_tables("cpu")[1].numpy()
    w = base[k, 0] - 1j * base[k, 1]                     # exp(-2 pi i k / 960)
    V = ((a + b) + w * (-1j) * (a - b)) / (2 * N)
    return np.concatenate([V.real, V.imag], 1)


def emulate_forward_spectral(mem, x, pbuf, start):
    """X, P [S, 962] f64 (not rounded) as the kernel computes them."""
    st = np.clip(start, 0, pbuf.shape[1] - N)
    p = np.stack([pbuf[s, st[s]:st[s] + N] for s in range(len(st))])
    return emulate_spectrum(np.concatenate([mem, x], 1)), emulate_spectrum(p)


def emulate_inverse(Y):
    """The inverse kernel's output [S, 960] f64 (not rounded) for spectra
    Y [S, 962] re|im: the first pass forms conj Z from bins k and 480 - k
    with the base twiddles, the stages (the radix-2 one included) transform
    it with the FFT table, and the window scales x[2m] = Re F[m],
    x[2m+1] = -Im F[m]."""
    base = spec.kernel_tables("cpu")[1].numpy()
    X = Y[:, :481].astype(np.float64) + 1j * Y[:, 481:].astype(np.float64)
    X[:, [0, 480]] = X[:, [0, 480]].real                 # bins 0 and 480 real
    k = np.arange(N // 2)
    a, b = np.conj(X[:, k]), X[:, N // 2 - k]
    t = base[k, 0] - 1j * base[k, 1]                     # exp(-2 pi i k / 960)
    F = emulate_fft((a + b) + (-1j) * (a - b) * t, spec.fft_tables("cpu").numpy()[N:])
    x = np.empty((Y.shape[0], N))
    x[:, 0::2], x[:, 1::2] = F.real, -F.imag
    return spec.kernel_tables("cpu")[0].numpy().astype(np.float64) * x


def _table_rows(radices):
    """Rows of the FFT table for these radices, as the kernel source sizes
    it: each stage after the first has (R - 1) x Ns twiddles, then R roots."""
    ns, rows = radices[0], 0
    for R in radices[1:]:
        rows += (R - 1) * ns + R
        ns *= R
    return rows


def test_radices_match_kernel_source():
    src = _source("spectral_common.cuh")
    got = dict((int(i), int(r)) for i, r in re.findall(r"FFT_R(\d) = (\d+)", src))
    radices = tuple(got[i] for i in range(len(got)))
    assert radices == fft_plan.FFT_RADICES
    assert int(np.prod(fft_plan.FFT_RADICES)) == fft_plan.H == N // 2
    # the kernel sizes its table from the same radices, one stage at a time
    assert re.search(r"FFT_OFF2 = FFT_OFF1 \+ fft_stage_size\(FFT_R1, FFT_NS1\),\s*"
                     r"FFT_TABLE = FFT_OFF2 \+ fft_stage_size\(FFT_R2, FFT_NS2\);", src)
    rows = _table_rows(radices)
    assert fft_plan.fft_table(spec.kernel_tables("cpu")[1].numpy()).shape == (rows, 2)


def test_fft_tables_extend_the_base_table():
    """The first 960 rows are the inverse's and the post-filter's table
    unchanged; every twiddle is a unit root taken from it, exact at the
    quarter turns."""
    base = spec.kernel_tables("cpu")[1]
    full = spec.fft_tables("cpu")
    assert full.dtype == torch.float64 \
        and full.shape == (N + _table_rows(fft_plan.FFT_RADICES), 2)
    assert torch.equal(full[:N], base)
    plan = full[N:].numpy()
    np.testing.assert_allclose(np.hypot(plan[:, 0], plan[:, 1]), 1.0, atol=1e-15)
    for R, ns, off in fft_plan.stages()[1:]:
        _, _, m = fft_plan.stage_maps(R, ns)
        jm = np.arange(ns)
        for r in range(1, R):
            row = plan[off + (r - 1) * ns + jm]
            want = fft_plan.forward_root(base.numpy(), m[:ns, r])
            assert np.array_equal(row, want)
        roots = plan[off + (R - 1) * ns + np.arange(R)]
        assert np.array_equal(roots, fft_plan.forward_root(base.numpy(), np.arange(R) * N // R))
    b = base.numpy()
    assert set(map(tuple, b[0::240])) == {(1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0)}


@pytest.mark.parametrize("scale", [3000.0, 3000.0 * 1e-4], ids=["random", "near_silent"])
def test_fft_emulation_matches_plain_and_reference(scale):
    """The stage sequence reproduces the plain f64 DFT to 1e-12 of each
    row's maximum, rounds to the plain version's f32 within an ulp, and
    meets the JAX package's windowed transform within 1e-5."""
    rng = np.random.default_rng(11)
    S = 6
    mem, x = ((scale * rng.standard_normal((S, 480))).astype(np.float32) for _ in range(2))
    pbuf = (scale * rng.standard_normal((S, 1728))).astype(np.float32)
    start = rng.integers(0, 769, S).astype(np.int32)
    start[:3] = (0, 768, 900)                   # the ends, and one clamped
    eX, eP = emulate_forward_spectral(mem, x, pbuf, start)

    v = torch.from_numpy(np.concatenate([mem, x], 1))
    p = spec.take_window(torch.from_numpy(pbuf), torch.from_numpy(start))
    for e, inp in ((eX, v), (eP, p)):
        plain64 = ttr.windowed_forward_transform_f64(inp).numpy()
        assert _rel(e, plain64) <= 1e-12
        # (bin 480's imaginary part: the plain matrix's sin(pi n) is ~1e-16,
        # the FFT's exact 0)
        ulps = _ulps(e.astype(np.float32), plain64.astype(np.float32))[:, :961]
        assert int(ulps.max()) <= 1
        # bins 0 and 480 have no imaginary part
        assert not e[:, 481].any() and not e[:, 961].any()
    jX = np.asarray(jtr.windowed_forward_transform(jnp.asarray(v.numpy())))
    jp = jtake(jnp.asarray(pbuf), jnp.asarray(np.clip(start, 0, 768)), 960, max_start=768)
    jP = np.asarray(jtr.windowed_forward_transform(jp))
    for e, j in ((eX, jX), (eP, jP)):
        assert _rel(e.astype(np.float32), np.concatenate([j.real, j.imag], 1)) <= 1e-5


def test_silent_input_gives_zero_spectrum():
    """Each input is its own sequence: a silent [mem | x] beside a loud
    pitch window (and the other way round) gives an exactly zero spectrum,
    as the plain DFT does."""
    rng = np.random.default_rng(13)
    loud = (3000 * rng.standard_normal((2, 960))).astype(np.float32)
    zero = np.zeros((2, 960), np.float32)
    pbuf = np.concatenate([loud, np.zeros((2, 768), np.float32)], 1)
    pbuf[1] = 0.0
    eX, eP = emulate_forward_spectral(zero[:, :480], np.stack([zero[0, 480:], loud[1, 480:]]),
                                      pbuf, np.zeros(2, np.int32))
    assert not eX[0].any() and eP[0].any()
    assert eX[1].any() and not eP[1].any()


def test_fft_f64_op_count():
    """The count chip_smoke.py's f64 floor uses: ~44 k per stream, ~20x
    fewer than the direct DFT's 2 x 481 x 960 multiply-adds."""
    ops = fft_plan.f64_ops_per_stream()
    assert 35_000 < ops < 50_000
    assert 2 * 481 * 960 / ops > 20


@pytest.mark.parametrize("scale", [1.0, 1e-4], ids=["random", "near_silent"])
def test_inverse_emulation_matches_plain_and_reference(scale):
    """The inverse's plan (first pass, stages, window) reproduces the f64
    windowed inverse DFT to 1e-12 of each row's maximum; rounded to f32 it
    meets the plain version (an f32 matmul) within 1e-6 of each row's
    maximum and the JAX package's inverse_spectral kernel (interpret mode)
    within 1e-5, and it ignores the imaginary parts of bins 0 and 480."""
    rng = np.random.default_rng(17)
    S = 6
    x = (3000 * scale * rng.standard_normal((S, N))).astype(np.float32)
    Y = ttr.windowed_forward_transform(torch.from_numpy(x)).numpy()
    Y[:, 240] *= 50.0                             # a loud bin beside the rest
    e = emulate_inverse(Y)
    inv64 = torch.from_numpy(Y).double() @ torch.from_numpy(
        ttr._dft_matrices(True)[1])
    assert _rel(e, inv64.numpy()) <= 1e-12
    plain = spec.inverse_spectral_plain(torch.from_numpy(Y)).numpy()
    assert _rel(e.astype(np.float32), plain) <= 1e-6
    Xc = jnp.asarray(Y[:, :481] + 1j * Y[:, 481:])
    ref = np.asarray(jps.inverse_spectral(jps.permute_spectrum(Xc), interpret=True))
    assert _rel(e.astype(np.float32), ref) <= 1e-5
    Y2 = Y.copy()
    Y2[:, 481], Y2[:, -1] = 5.0, -7.0
    assert np.array_equal(emulate_inverse(Y2), e)


def test_silent_spectrum_gives_zero_output():
    """A silent spectrum beside loud ones inverts to exact zeros."""
    rng = np.random.default_rng(19)
    Y = (rng.standard_normal((3, 962))).astype(np.float32)
    Y[1] = 0.0
    e = emulate_inverse(Y)
    assert not e[1].any() and e[0].any() and e[2].any()


def test_inverse_uses_the_forward_stages_and_table():
    """The inverse runs the forward's stages with the same radices, stage
    offsets and FFT table: inv_spectra calls the stage functions with the
    template arguments fwd_spectra uses (both a butterfly a thread), and the
    standalone inverse kernel stages the base twiddles it reads (k < 480)
    and the FFT table, with a butterfly of each of its streams per
    thread."""
    src = _source("spectral_common.cuh")
    fwd = src[src.index("void fwd_spectra("):src.index("void inv_spectra(")]
    inv = src[src.index("void inv_spectra("):]
    calls = r"fft_stage\w*<[^>]+>\(n\w+, buf, ft\);"
    whole = re.findall(calls, fwd)
    assert len(whole) == 2 and whole == \
        [c.replace("nstr", "nseq") for c in re.findall(calls, inv)]
    kern = _source("spectral.cu")
    assert "__shared__ double2 s_tw[FH + FFT_TABLE];" in kern
    assert "s_tw[i] = i < FH ? tw[i] : tw[WS + i - FH];" in kern
    assert "constexpr int INV_THREADS = GI * FH / FFT_R2;" in kern
    # the first pass reads base twiddles k < 480, the stages the table rows
    assert _table_rows(fft_plan.FFT_RADICES) == fft_plan.fft_table(
        spec.kernel_tables("cpu")[1].numpy()).shape[0]


def test_inverse_f64_op_count():
    """About 21 k f64 operations a spectrum, half the forward's two
    sequences, and over 20x fewer than the direct DFT's 481 x 960."""
    ops = fft_plan.inverse_f64_ops_per_stream()
    assert 15_000 < ops < 25_000
    assert 481 * 960 / ops > 20
    assert ops < fft_plan.f64_ops_per_stream() / 2


def test_lag_tile_shape_matches_kernel_source():
    src = _source("analysis_body.cuh")
    assert int(re.search(r"LAG_TILE = (\d+);", src).group(1)) == cuda_xcorr.LAGS_PER_THREAD
    assert int(re.search(r"TAP_SLICE = (\d+);", src).group(1)) == cuda_xcorr.TAPS_PER_SLICE
    assert int(re.search(r"SLICE_LANES = (\d+);", src).group(1)) == cuda_xcorr.SLICE_LANES


def test_lag_partition_covers_each_pair_once_in_fixed_order():
    """Every (lag, tap) pair belongs to exactly one thread; each thread sums
    its taps in ascending order; a lag's slices meet as ((s0 + s1) + (s2 +
    s3)).  Summed so in numpy, the table meets the plain f64 version to
    1e-12 of each row's maximum and its f32 rounding within an ulp."""
    part = cuda_xcorr.lag_tile_partition()
    seen = np.zeros((cuda_xcorr.N_LAGS, cuda_xcorr.CORR_LEN), np.int64)
    for _, lags, taps in part:
        assert list(taps) == sorted(taps) and len(lags) == cuda_xcorr.LAGS_PER_THREAD
        seen[np.ix_(list(lags), list(taps))] += 1
    assert (seen == 1).all()

    rng = np.random.default_rng(12)
    S = 5
    ds = (300 * rng.standard_normal((S, cuda_xcorr.DS_LEN))).astype(np.float32)
    ds[1] *= 1e-4                                   # a near-silent stream
    d = ds.astype(np.float64)
    x = d[:, cuda_xcorr.X_OFF:]
    slices = np.zeros((S, cuda_xcorr.TAP_SLICES, cuda_xcorr.N_LAGS))
    for t, lags, taps in part:
        sl = taps[0] // cuda_xcorr.TAPS_PER_SLICE
        for i in lags:
            acc = np.zeros(S)
            for j in taps:                          # ascending, as the kernel
                acc = acc + x[:, j] * d[:, i + j]
            slices[:, sl, i] = acc
    tot = (slices[:, 0] + slices[:, 1]) + (slices[:, 2] + slices[:, 3])
    plain64 = torch.nn.functional.conv1d(
        torch.from_numpy(d)[None], torch.from_numpy(x)[:, None], groups=S)[0].numpy()
    assert _rel(tot, plain64) <= 1e-12
    bx = cuda_xcorr.lag_corr_table_plain(torch.from_numpy(ds)).numpy()
    assert int(_ulps(tot.astype(np.float32), bx).max()) <= 1
